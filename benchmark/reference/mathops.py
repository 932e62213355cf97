"""Elementwise math of the reference: spherical harmonics, rotations and
covariances, the sky sphere, the learning-rate schedule, and the one matrix
product helper.

A frozen copy of the port's plain float32 math (its `utils/sh.py`,
`utils/graphics.py`, `utils/general.py`), kept here so the yardstick does not
move when the program does. Every product that feeds a color is written out
elementwise, except the MLP's layers and the specular SH contraction, which
go through `mm` / `linear`: those two are where a lower precision (TF32) would
enter, and `tf32=True` rounds their operands as a TF32 tensor core does (the
benchmark's control).
"""

from __future__ import annotations

import math

import numpy as np
import torch

C0 = 0.28209479177387814
C1 = 0.4886025119029199
C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005, -1.0925484305920792,
      0.5462742152960396)
C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658, 0.3731763325901154,
      -0.4570457994644658, 1.445305721320277, -0.5900435899266435)
C4 = (2.5033429417967046, -1.7701307697799304, 0.9461746957575601, -0.6690465435572892,
      0.10578554691520431, -0.6690465435572892, 0.47308734787878004, -1.7701307697799304,
      0.6258357354491761)


# ------------------------------------------------------------------ precision


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (10 mantissa bits, ties to even), as
    float32: what a TF32 tensor core multiplies."""
    i = x.contiguous().view(torch.int32)
    bias = ((i >> 13) & 1) + 0xFFF
    return ((i + bias) & ~0x1FFF).view(torch.float32)


class _TF32MatMul(torch.autograd.Function):
    """a @ b as a TF32 tensor core computes it, forward and backward: each
    product's operands rounded to TF32, the sums in float32."""

    @staticmethod
    def forward(ctx, a, b):
        ra, rb = round_tf32(a), round_tf32(b)
        ctx.save_for_backward(ra, rb)
        return ra @ rb

    @staticmethod
    def backward(ctx, g):
        ra, rb = ctx.saved_tensors
        rg = round_tf32(g)
        return rg @ rb.t(), ra.t() @ rg


def mm(a: torch.Tensor, b: torch.Tensor, tf32: bool = False) -> torch.Tensor:
    """a @ b in float32, or as a TF32 tensor core computes it (`tf32`)."""
    return _TF32MatMul.apply(a, b) if tf32 else a @ b


def linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, tf32: bool = False) -> torch.Tensor:
    """x @ w.T + b (torch.nn.Linear's weight layout)."""
    return mm(x, w.t(), tf32) + b


# ------------------------------------------------------------------ SH


def sh_basis(deg: int, dirs: torch.Tensor) -> torch.Tensor:
    """Real SH basis at unit directions [..., 3] -> [..., (deg+1)**2] (degree <= 4)."""
    if not 0 <= deg <= 4:
        raise ValueError(f"SH degree must be in [0, 4], got {deg}")
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    out = [C0 * torch.ones_like(x)]
    if deg > 0:
        out += [-C1 * y, C1 * z, -C1 * x]
    if deg > 1:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        out += [C2[0] * xy, C2[1] * yz, C2[2] * (2.0 * zz - xx - yy), C2[3] * xz,
                C2[4] * (xx - yy)]
    if deg > 2:
        out += [
            C3[0] * y * (3 * xx - yy),
            C3[1] * xy * z,
            C3[2] * y * (4 * zz - xx - yy),
            C3[3] * z * (2 * zz - 3 * xx - 3 * yy),
            C3[4] * x * (4 * zz - xx - yy),
            C3[5] * z * (xx - yy),
            C3[6] * x * (xx - 3 * yy),
        ]
    if deg > 3:
        out += [
            C4[0] * xy * (xx - yy),
            C4[1] * yz * (3 * xx - yy),
            C4[2] * xy * (7 * zz - 1),
            C4[3] * yz * (7 * zz - 3),
            C4[4] * (zz * (35 * zz - 30) + 3),
            C4[5] * xz * (7 * zz - 3),
            C4[6] * (xx - yy) * (7 * zz - 1),
            C4[7] * xz * (xx - 3 * yy),
            C4[8] * (xx * (xx - 3 * yy) - yy * (3 * xx - yy)),
        ]
    return torch.stack(out, dim=-1)


def eval_sh(deg: int, sh: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """sh [..., C, >=(deg+1)**2] at unit directions [..., 3] -> [..., C]."""
    n = (deg + 1) ** 2
    return torch.sum(sh[..., :n] * sh_basis(deg, dirs)[..., None, :], dim=-1)


def gauss_kernel(roughness: torch.Tensor, deg: int) -> torch.Tensor:
    """Per-band attenuation exp(-l(l+1) * 0.3 * roughness): [..., 1] -> [..., (deg+1)**2]."""
    band = np.floor(np.sqrt(np.arange((deg + 1) ** 2)))
    l = torch.as_tensor(band, dtype=roughness.dtype, device=roughness.device)
    return torch.exp(-(l * (l + 1.0)) * (0.3 * roughness))


def gamma_correction(rgb: torch.Tensor, gamma: float = 2.2) -> torch.Tensor:
    return (torch.clamp(rgb, 0.0, 1.0) + 1e-4) ** (1.0 / gamma)


# ------------------------------------------------------------------ geometry


def safe_normalize(x: torch.Tensor, eps: float = 1e-20) -> torch.Tensor:
    """x / |x| with the squared norm clamped (the rotations' normalization)."""
    return x * torch.rsqrt(torch.clamp_min(torch.sum(x * x, dim=-1, keepdim=True), eps))


def safe_normalize_div(x: torch.Tensor, eps: float = 1e-20) -> torch.Tensor:
    """x / sqrt(|x|^2) with the squared norm clamped (the shading's normalization)."""
    return x / torch.sqrt(torch.clamp_min(torch.sum(x * x, dim=-1, keepdim=True), eps))


def rotmat_entries(q: torch.Tensor):
    r, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return (1 - 2 * (y * y + z * z), 2 * (x * y - r * z), 2 * (x * z + r * y),
            2 * (x * y + r * z), 1 - 2 * (x * x + z * z), 2 * (y * z - r * x),
            2 * (x * z - r * y), 2 * (y * z + r * x), 1 - 2 * (x * x + y * y))


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """Quaternion (w, x, y, z), normalized here -> [..., 3, 3]."""
    return torch.stack(rotmat_entries(safe_normalize(q)), dim=-1).reshape(q.shape[:-1] + (3, 3))


def covariance_3d(scales: torch.Tensor, quats: torch.Tensor) -> torch.Tensor:
    """R S S^T R^T as (xx, xy, xz, yy, yz, zz), quaternion taken as given."""
    r00, r01, r02, r10, r11, r12, r20, r21, r22 = rotmat_entries(quats)
    s0, s1, s2 = scales[..., 0], scales[..., 1], scales[..., 2]
    s0, s1, s2 = s0 * s0, s1 * s1, s2 * s2
    return torch.stack([
        r00 * r00 * s0 + r01 * r01 * s1 + r02 * r02 * s2,
        r00 * r10 * s0 + r01 * r11 * s1 + r02 * r12 * s2,
        r00 * r20 * s0 + r01 * r21 * s1 + r02 * r22 * s2,
        r10 * r10 * s0 + r11 * r11 * s1 + r12 * r12 * s2,
        r10 * r20 * s0 + r11 * r21 * s1 + r12 * r22 * s2,
        r20 * r20 * s0 + r21 * r21 * s1 + r22 * r22 * s2,
    ], dim=-1)


def min_axis(scales: torch.Tensor, R: torch.Tensor) -> torch.Tensor:
    """The column of R of the smallest scale (the first of equal ones)."""
    s0, s1, s2 = scales[..., 0:1], scales[..., 1:2], scales[..., 2:3]
    first01 = s0 <= s1
    ax01 = torch.where(first01, R[..., 0], R[..., 1])
    s01 = torch.where(first01, s0, s1)
    return torch.where(s01 <= s2, ax01, R[..., 2])


def flip_to_viewer(normal: torch.Tensor, viewdir: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.sum(normal * -viewdir, dim=-1, keepdim=True) >= 0, normal, -normal)


def polar_to_cartesian(angles: torch.Tensor, center: torch.Tensor, radius) -> torch.Tensor:
    """Sky (theta, phi) -> points on the sky sphere (y down)."""
    theta, phi = angles[..., 0], angles[..., 1]
    return torch.stack([radius * torch.sin(theta) * torch.sin(phi) + center[0],
                        -radius * torch.cos(theta) + center[1],
                        radius * torch.sin(theta) * torch.cos(phi) + center[2]], dim=-1)


def cartesian_to_polar(xyz: torch.Tensor, center: torch.Tensor, radius) -> torch.Tensor:
    theta = torch.arccos(torch.clamp((-xyz[..., 1] + center[1]) / radius, -1, 1))
    phi = torch.arctan2(xyz[..., 0] - center[0], xyz[..., 2] - center[2])
    return torch.stack([theta, phi], dim=-1)


def ndc_to_pixel(v: torch.Tensor, size) -> torch.Tensor:
    return ((v + 1.0) * size - 1.0) * 0.5


def depth_to_normal(depth: torch.Tensor, c2w: torch.Tensor, tan_fovx, tan_fovy) -> torch.Tensor:
    """Central-difference world normals [H, W, 3] of a z-depth map, zero on the border."""
    H, W = depth.shape
    fx, fy = W / (2.0 * tan_fovx), H / (2.0 * tan_fovy)
    gy, gx = torch.meshgrid(torch.arange(H, dtype=depth.dtype, device=depth.device),
                            torch.arange(W, dtype=depth.dtype, device=depth.device),
                            indexing="ij")
    dx, dy = (gx - W / 2.0) / fx, (gy - H / 2.0) / fy
    R = c2w[:3, :3]
    rays = [dx * R[i, 0] + dy * R[i, 1] + R[i, 2] for i in range(3)]
    pts = torch.stack([depth * rays[i] + c2w[i, 3] for i in range(3)], dim=-1)
    ddx = pts[2:, 1:-1] - pts[:-2, 1:-1]
    ddy = pts[1:-1, 2:] - pts[1:-1, :-2]
    n = safe_normalize(torch.linalg.cross(ddx, ddy, dim=-1))
    return torch.nn.functional.pad(n, (0, 0, 1, 1, 1, 1))


def projection_matrix(znear: float, zfar: float, fovx: float, fovy: float) -> np.ndarray:
    """The reference's getProjectionMatrix (apply as P @ p), float32."""
    P = np.zeros((4, 4), dtype=np.float32)
    P[0, 0] = 1.0 / math.tan(fovx / 2)
    P[1, 1] = 1.0 / math.tan(fovy / 2)
    P[2, 2] = zfar / (zfar - znear)
    P[2, 3] = -(zfar * znear) / (zfar - znear)
    P[3, 2] = 1.0
    return P


def expon_lr(step: torch.Tensor, lr_init: float, lr_final: float, delay_mult: float,
             max_steps: int) -> torch.Tensor:
    """The reference's position schedule: log-lerp, no delay steps."""
    step = step.to(torch.float32)
    t = torch.clamp(step / max_steps, 0, 1)
    lr = torch.exp(math.log(lr_init) * (1 - t) + math.log(lr_final) * t)
    return torch.where(step < 0, 0.0, lr)
