"""The split-sum environment-BRDF table (FG LUT) of the reference's shading.

The reference reads a [256, 256, 2] table of the GGX integrals A and B over
(N.V, roughness), integrated with 4096 Hammersley samples (Karis' split sum,
NVDIFFREC's `bsdf_ndf_ggx` / Smith height-correlated masking). The program
builds its own copy of that table; the reference works it out again here, in
float64 on the reference's device, a block of roughness rows at a time.
"""

from __future__ import annotations

import math

import torch


def hammersley(n: int, device) -> torch.Tensor:
    """[n, 2] float64: (i / n, radical inverse of i in base 2)."""
    i = torch.arange(n, dtype=torch.int64, device=device)
    bits = torch.zeros_like(i)
    for b in range(32):
        bits |= ((i >> b) & 1) << (31 - b)
    return torch.stack([i.double() / n, bits.double() * 2.3283064365386963e-10], dim=-1)


def fg_lut(size: int = 256, num_samples: int = 4096, device="cpu", rows_per_block: int = 16):
    """[size, size, 2] float32: [..., 0] = A (scale), [..., 1] = B (bias);
    columns index N.V, rows roughness, both at texel centres."""
    xi = hammersley(num_samples, device)
    ndotv = (torch.arange(size, dtype=torch.float64, device=device) + 0.5) / size
    rough = (torch.arange(size, dtype=torch.float64, device=device) + 0.5) / size
    V = torch.stack([torch.sqrt(1.0 - ndotv ** 2), torch.zeros_like(ndotv), ndotv], dim=-1)
    out = torch.empty((size, size, 2), dtype=torch.float64, device=device)
    phi = 2.0 * math.pi * xi[:, 0]
    nv = ndotv[None, :, None]                                          # [1, U, 1]
    for r0 in range(0, size, rows_per_block):
        a = (rough[r0:r0 + rows_per_block] ** 2)[:, None]              # [R, 1]
        cos_t = torch.sqrt((1.0 - xi[:, 1]) / (1.0 + (a * a - 1.0) * xi[:, 1]))   # [R, S]
        sin_t = torch.sqrt(torch.clamp_min(1.0 - cos_t ** 2, 0.0))
        hx, hz = torch.cos(phi) * sin_t, cos_t   # V has no y component
        vdoth = V[None, :, 0, None] * hx[:, None] + V[None, :, 2, None] * hz[:, None]  # [R, U, S]
        ndotl = 2.0 * vdoth * hz[:, None] - V[None, :, 2, None]
        ndoth = torch.clamp_min(hz, 0.0)[:, None]
        a2 = (a * a)[:, :, None]
        lam_v = (torch.sqrt(1.0 + a2 * (1.0 - nv ** 2) / torch.clamp_min(nv ** 2, 1e-12)) - 1) / 2
        cl = torch.clamp(ndotl, 0.0, 1.0)
        lam_l = (torch.sqrt(1.0 + a2 * (1.0 - cl ** 2) / torch.clamp_min(cl ** 2, 1e-12)) - 1) / 2
        g_vis = (1.0 / (1.0 + lam_v + lam_l)) * vdoth / torch.clamp_min(ndoth * nv, 1e-8)
        fc = (1.0 - torch.clamp(vdoth, 0.0, 1.0)) ** 5
        valid = ndotl > 0
        out[r0:r0 + rows_per_block, :, 0] = torch.where(valid, (1 - fc) * g_vis, 0.0).sum(-1)
        out[r0:r0 + rows_per_block, :, 1] = torch.where(valid, fc * g_vis, 0.0).sum(-1)
    return (out / num_samples).to(torch.float32)


def sample_bilinear(tex: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Clamped bilinear sample of tex [H, W, C] at uv [..., 2] (texel centres at
    (i + 0.5) / size, u along the width; the fraction is zeroed left of the
    first centre, where the clamped lerp degenerates)."""
    H, W = tex.shape[0], tex.shape[1]
    u = uv[..., 0] * W - 0.5
    v = uv[..., 1] * H - 0.5
    u0, v0 = torch.floor(u), torch.floor(v)
    fu = torch.where(u0 < 0, 0.0, u - u0)[..., None]
    fv = torch.where(v0 < 0, 0.0, v - v0)[..., None]
    u0i, v0i = torch.clamp(u0.long(), 0, W - 1), torch.clamp(v0.long(), 0, H - 1)
    u1i, v1i = torch.clamp(u0i + 1, max=W - 1), torch.clamp(v0i + 1, max=H - 1)
    return (tex[v0i, u0i] * (1 - fu) * (1 - fv) + tex[v0i, u1i] * fu * (1 - fv)
            + tex[v1i, u0i] * (1 - fu) * fv + tex[v1i, u1i] * fu * fv)
