"""Clamped bilinear texture sampling: port of the JAX package's `ops/texture.py`
(`bilinear_sample`; `pack_bilinear_quads` / `bilinear_sample_packed`, which the
FG LUT lookup uses)."""

from __future__ import annotations

import numpy as np
import torch


def bilinear_sample(tex: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Sample a texture bilinearly with clamped borders (nvdiffrast's
    `filter_mode='linear', boundary_mode='clamp'`): texel i's centre is at
    (i + 0.5) / size; u indexes width, v height.

    Args:
        tex: [H, W, C] texture.
        uv: [..., 2] coordinates (u, v).
    Returns:
        [..., C]
    """
    H, W = tex.shape[0], tex.shape[1]
    u = uv[..., 0] * W - 0.5
    v = uv[..., 1] * H - 0.5
    u0 = torch.floor(u)
    v0 = torch.floor(v)
    fu = (u - u0)[..., None]
    fv = (v - v0)[..., None]
    u0i = torch.clamp(u0.long(), 0, W - 1)
    u1i = torch.clamp(u0.long() + 1, 0, W - 1)
    v0i = torch.clamp(v0.long(), 0, H - 1)
    v1i = torch.clamp(v0.long() + 1, 0, H - 1)
    return (tex[v0i, u0i] * (1 - fu) * (1 - fv)
            + tex[v0i, u1i] * fu * (1 - fv)
            + tex[v1i, u0i] * (1 - fu) * fv
            + tex[v1i, u1i] * fu * fv)


def pack_bilinear_quads(tex: np.ndarray) -> np.ndarray:
    """[H, W, C] -> [H, W, 4C] where quad[v, u] = (t00, t01, t10, t11) with clamped
    +1 neighbours, so a bilinear sample is one row gather."""
    H, W = tex.shape[0], tex.shape[1]
    u1 = np.minimum(np.arange(W) + 1, W - 1)
    v1 = np.minimum(np.arange(H) + 1, H - 1)
    t01 = tex[:, u1]
    t10 = tex[v1, :]
    t11 = t10[:, u1]
    return np.concatenate([tex, t01, t10, t11], axis=-1)


def bilinear_sample_packed(quad_tex: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Clamped bilinear sample (texel-center convention, u along width) of a
    pack_bilinear_quads texture.

    Args:
        quad_tex: [H, W, 4C] packed texture.
        uv: [..., 2].
    Returns:
        [..., C]
    """
    H, W = quad_tex.shape[0], quad_tex.shape[1]
    C = quad_tex.shape[2] // 4
    u = uv[..., 0] * W - 0.5
    v = uv[..., 1] * H - 0.5
    u0 = torch.floor(u)
    v0 = torch.floor(v)
    # Left/top border: zero the fraction (the clamped lerp degenerates there).
    fu = torch.where(u0 < 0, 0.0, u - u0)[..., None]
    fv = torch.where(v0 < 0, 0.0, v - v0)[..., None]
    u0i = torch.clamp(u0.long(), 0, W - 1)
    v0i = torch.clamp(v0.long(), 0, H - 1)
    q = quad_tex[v0i, u0i]                                       # [..., 4C]
    t00, t01, t10, t11 = q[..., :C], q[..., C:2 * C], q[..., 2 * C:3 * C], q[..., 3 * C:]
    return (
        t00 * (1 - fu) * (1 - fv)
        + t01 * fu * (1 - fv)
        + t10 * (1 - fu) * fv
        + t11 * fu * fv
    )
