"""Camera / projection / rotation / covariance math.

Port of the JAX package's `utils/graphics.py`.
Math convention throughout: `p_view = viewmat @ [p, 1]`.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch


class BasicPointCloud(NamedTuple):
    points: np.ndarray
    colors: np.ndarray
    normals: np.ndarray


def world_to_view(R: np.ndarray, t: np.ndarray, translate=None, scale: float = 1.0) -> np.ndarray:
    """World->view 4x4 (math convention), the reference's `getWorld2View2`: R is
    the world-from-cam rotation (COLMAP's cam-from-world transposed), t the
    cam-from-world translation; an optional translate/scale recentres the
    camera centre."""
    Rt = np.zeros((4, 4), dtype=np.float64)
    Rt[:3, :3] = R.T
    Rt[:3, 3] = t
    Rt[3, 3] = 1.0
    if translate is not None or scale != 1.0:
        translate = np.zeros(3) if translate is None else np.asarray(translate)
        C2W = np.linalg.inv(Rt)
        C2W[:3, 3] = (C2W[:3, 3] + translate) * scale
        Rt = np.linalg.inv(C2W)
    return Rt.astype(np.float32)


def fov2focal(fov: float, pixels: float) -> float:
    return pixels / (2 * math.tan(fov / 2))


def focal2fov(focal: float, pixels: float) -> float:
    return 2 * math.atan(pixels / (2 * focal))


def camera_intrinsics(fovx: float, fovy: float, W: int, H: int) -> np.ndarray:
    """3x3 intrinsics with the principal point at W/2, H/2."""
    fx = fov2focal(fovx, W)
    fy = fov2focal(fovy, H)
    return np.array([[fx, 0, W / 2.0], [0, fy, H / 2.0], [0, 0, 1.0]], dtype=np.float32)


def projection_matrix(znear: float, zfar: float, fovx: float, fovy: float) -> np.ndarray:
    """OpenGL-style perspective with z in [0, zfar/(zfar-znear)] and +z forward
    (the reference `getProjectionMatrix`, math convention: apply as P @ p)."""
    tan_hx = math.tan(fovx / 2)
    tan_hy = math.tan(fovy / 2)
    P = np.zeros((4, 4), dtype=np.float32)
    P[0, 0] = 1.0 / tan_hx
    P[1, 1] = 1.0 / tan_hy
    P[2, 2] = zfar / (zfar - znear)
    P[2, 3] = -(zfar * znear) / (zfar - znear)
    P[3, 2] = 1.0
    return P


def ndc_to_pixel(v: torch.Tensor, size) -> torch.Tensor:
    """NDC [-1,1] -> continuous pixel center coordinate."""
    return ((v + 1.0) * size - 1.0) * 0.5


def safe_normalize(x: torch.Tensor, eps: float = 1e-20) -> torch.Tensor:
    """x / |x| with a clamped squared norm (finite gradient at 0)."""
    return x * torch.rsqrt(torch.clamp_min(torch.sum(x * x, dim=-1, keepdim=True), eps))


def _rotmat_entries(q: torch.Tensor):
    r, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return (
        1 - 2 * (y * y + z * z), 2 * (x * y - r * z), 2 * (x * z + r * y),
        2 * (x * y + r * z), 1 - 2 * (x * x + z * z), 2 * (y * z - r * x),
        2 * (x * z - r * y), 2 * (y * z + r * x), 1 - 2 * (x * x + y * y),
    )


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """Quaternion (w, x, y, z) -> [..., 3, 3] rotation matrix (normalizes q)."""
    R = torch.stack(_rotmat_entries(safe_normalize(q)), dim=-1)
    return R.reshape(q.shape[:-1] + (3, 3))


def quat_to_rotmat_raw(q: torch.Tensor) -> torch.Tensor:
    """Like quat_to_rotmat without the normalization, as the rasterizer's
    computeCov3D, which takes the model's already normalized rotations."""
    R = torch.stack(_rotmat_entries(q), dim=-1)
    return R.reshape(q.shape[:-1] + (3, 3))


def build_scaling_rotation(scales: torch.Tensor, quats: torch.Tensor) -> torch.Tensor:
    """L = R @ diag(s): the columns are the scaled principal axes."""
    return quat_to_rotmat(quats) * scales[..., None, :]


def covariance_3d(scales: torch.Tensor, quats: torch.Tensor,
                  scale_modifier: float = 1.0) -> torch.Tensor:
    """World covariance R S S^T R^T as (xx, xy, xz, yy, yz, zz), with the raw
    (non-normalizing) quaternion convention of the rasterizer's computeCov3D."""
    r00, r01, r02, r10, r11, r12, r20, r21, r22 = _rotmat_entries(quats)
    s0 = scale_modifier * scales[..., 0]
    s1 = scale_modifier * scales[..., 1]
    s2 = scale_modifier * scales[..., 2]
    s0, s1, s2 = s0 * s0, s1 * s1, s2 * s2
    xx = r00 * r00 * s0 + r01 * r01 * s1 + r02 * r02 * s2
    xy = r00 * r10 * s0 + r01 * r11 * s1 + r02 * r12 * s2
    xz = r00 * r20 * s0 + r01 * r21 * s1 + r02 * r22 * s2
    yy = r10 * r10 * s0 + r11 * r11 * s1 + r12 * r12 * s2
    yz = r10 * r20 * s0 + r11 * r21 * s1 + r12 * r22 * s2
    zz = r20 * r20 * s0 + r21 * r21 * s1 + r22 * r22 * s2
    return torch.stack([xx, xy, xz, yy, yz, zz], dim=-1)


def depths_to_points(depth: torch.Tensor, c2w: torch.Tensor, tan_fovx, tan_fovy) -> torch.Tensor:
    """Backproject a z-depth map [H, W] to world points [H, W, 3] through the
    camera-to-world matrix `c2w` (principal point at W/2, H/2)."""
    H, W = depth.shape
    fx = W / (2.0 * tan_fovx)
    fy = H / (2.0 * tan_fovy)
    gy, gx = torch.meshgrid(torch.arange(H, dtype=depth.dtype, device=depth.device),
                            torch.arange(W, dtype=depth.dtype, device=depth.device),
                            indexing="ij")
    dx = (gx - W / 2.0) / fx
    dy = (gy - H / 2.0) / fy
    # Ray directions c2w[:3, :3] @ (dx, dy, 1), written out elementwise so no
    # TF32 product can reach them.
    R = c2w[:3, :3]
    rays = [dx * R[i, 0] + dy * R[i, 1] + R[i, 2] for i in range(3)]
    return torch.stack([depth * rays[i] + c2w[i, 3] for i in range(3)], dim=-1)


def depth_to_normal(depth: torch.Tensor, c2w: torch.Tensor, tan_fovx, tan_fovy) -> torch.Tensor:
    """Central-difference world-space normals [H, W, 3] of a depth map, zero on
    the 1 px border."""
    points = depths_to_points(depth, c2w, tan_fovx, tan_fovy)
    dx = points[2:, 1:-1] - points[:-2, 1:-1]
    dy = points[1:-1, 2:] - points[1:-1, :-2]
    n = safe_normalize(torch.linalg.cross(dx, dy, dim=-1))
    return torch.nn.functional.pad(n, (0, 0, 1, 1, 1, 1))
