"""Equirectangular environment map <-> SH, and real-SH rotation, on the host.

Port of the JAX package's `utils/envmap.py` (the reference's
`utils/sh_additional_utils.py` projection with per-row solid angles and its
Lambertian-convolved `sh_render`, and a quadrature SH rotation in place of
`spaudiopy.sph.rotate_sh`). Numpy over this package's `utils/sh.sh_basis`,
evaluated in float32 on the CPU as the JAX package evaluates its basis.

Direction convention: envmap row theta in [0, pi] from the top, column phi in
[0, 2pi); d = (sin t sin p, -cos t, sin t cos p), so the top row is world "up"
(-y in COLMAP coordinates). Projection, rendering, rotation and `eval_sh` all
use the one signed cartesian basis of utils/sh.py.

SH rotation is an exact quadrature projection: for band-limited f,
coeffs' = B^T W B_rot coeffs, with B the basis on a Gauss-Legendre x uniform-phi
grid and B_rot the basis at the inverse-rotated directions.

Envmaps wider than 1000 pixels, or not 2:1, are resized first with a bicubic
filter (a = -0.75, the pixel-centre mapping and replicated borders of
OpenCV's INTER_CUBIC, which the JAX package calls); OpenCV is not needed.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from .sh import sh_basis


def equirect_dirs(width: int) -> np.ndarray:
    """[H, W, 3] directions for an equirect map (H = width // 2)."""
    height = width // 2
    theta = (np.arange(height) + 0.5) / height * np.pi
    phi = (np.arange(width) + 0.5) / width * 2 * np.pi
    t, p = np.meshgrid(theta, phi, indexing="ij")
    st = np.sin(t)
    return np.stack([st * np.sin(p), -np.cos(t), st * np.cos(p)], axis=-1)


def solid_angle_map(width: int) -> np.ndarray:
    """[H, W] per-pixel solid angles."""
    height = width // 2
    theta = (np.arange(height) + 0.5) / height * np.pi
    dphi = 2 * np.pi / width
    dtheta = np.pi / height
    sa = dphi * (np.cos(theta - dtheta / 2) - np.cos(theta + dtheta / 2))
    return np.repeat(sa[:, None], width, axis=1)


def _basis(deg: int, dirs: np.ndarray) -> np.ndarray:
    """The SH basis at float32 directions, as numpy."""
    return sh_basis(deg, torch.as_tensor(np.asarray(dirs, np.float32))).numpy()


def _basis_map(width: int, deg: int) -> np.ndarray:
    return _basis(deg, equirect_dirs(width))


def resize_cubic(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """[h, w, c] float image -> [height, width, c], bicubic (a = -0.75, pixel
    centres, replicated borders, no antialiasing)."""
    x = torch.as_tensor(np.ascontiguousarray(img, np.float32)).permute(2, 0, 1)[None]
    y = F.interpolate(x, size=(height, width), mode="bicubic", align_corners=False)
    return y[0].permute(1, 2, 0).numpy()


def project_envmap_to_sh(img: np.ndarray, deg: int = 4) -> np.ndarray:
    """Project an equirect HDR/LDR image onto the SH basis.

    Args:
        img: [H, W, 3], H = W // 2 (resized if not, and to 1000 x 500 if wider).
    Returns:
        [(deg+1)**2, 3]
    """
    if img.shape[1] > 1000:
        img = resize_cubic(img, 1000, 500)
    if img.shape[0] != img.shape[1] // 2:
        img = resize_cubic(img, img.shape[1], img.shape[1] // 2)
    w = img.shape[1]
    B = _basis_map(w, deg)                      # [H, W, K]
    sa = solid_angle_map(w)                     # [H, W]
    return np.einsum("hwk,hwc,hw->kc", B, img[..., :3], sa)


def saturate_envmap(img: np.ndarray, threshold: float, scale: float) -> np.ndarray:
    """Boost saturated pixels before projection."""
    img = img.astype(np.float32).copy()
    img[img > threshold] *= scale
    return img


def diffuse_band_coefficients(l_max: int) -> np.ndarray:
    """Lambertian convolution band coefficients / pi."""
    out = [np.pi, (2 * np.pi) / 3]
    for l in range(2, l_max + 1):
        if l % 2 == 0:
            a = (-1.0) ** (l / 2.0 - 1.0)
            b = (l + 2.0) * (l - 1.0)
            c = math.factorial(l) / (2**l * math.factorial(l // 2) ** 2)
            out.append(2 * np.pi * (a / b) * c)
        else:
            out.append(0.0)
    return np.asarray(out) / np.pi


def render_sh_map(coeffs: np.ndarray, width: int = 600, convolve_diffuse: bool = True) -> np.ndarray:
    """Render SH coefficients [K, 3] to an equirect image [width // 2, width, 3];
    by default with the Lambertian band convolution."""
    K = coeffs.shape[0]
    deg = int(math.isqrt(K)) - 1
    B = _basis_map(width, deg)
    c = coeffs.astype(np.float64).copy()
    if convolve_diffuse:
        bands = diffuse_band_coefficients(deg)
        l_per = np.floor(np.sqrt(np.arange(K))).astype(int)
        c = c * bands[l_per][:, None]
    return np.einsum("hwk,kc->hwc", B, c).astype(np.float32)


@lru_cache(maxsize=8)
def _quadrature(deg: int):
    n_theta = 4 * (deg + 1)
    n_phi = 8 * (deg + 1)
    x, wx = np.polynomial.legendre.leggauss(n_theta)
    phi = (np.arange(n_phi) + 0.5) * 2 * np.pi / n_phi
    ct, p = np.meshgrid(x, phi, indexing="ij")
    st = np.sqrt(1 - ct**2)
    d = np.stack([st * np.cos(p), st * np.sin(p), ct], axis=-1).reshape(-1, 3)
    w = (np.broadcast_to(wx[:, None], ct.shape) * (2 * np.pi / n_phi)).reshape(-1)
    return d, w


def euler_zyx_matrix(yaw: float, pitch: float, roll: float) -> np.ndarray:
    """R = Rz(yaw) @ Ry(pitch) @ Rx(roll), spaudiopy.sph.rotate_sh's convention."""
    cz, sz = np.cos(yaw), np.sin(yaw)
    cy, sy = np.cos(pitch), np.sin(pitch)
    cx, sx = np.cos(roll), np.sin(roll)
    Rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    Rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    return Rz @ Ry @ Rx


def sh_rotation_matrix(R: np.ndarray, deg: int) -> np.ndarray:
    """[K, K] matrix M with coeffs_rotated = M @ coeffs, exact for band-limited
    functions: f'(d) = f(R^T d)."""
    d, w = _quadrature(deg)
    B = _basis(deg, d).astype(np.float64)
    Brot = _basis(deg, d @ R).astype(np.float64)
    return (B * w[:, None]).T @ Brot


def rotate_sh(coeffs: np.ndarray, yaw: float = 0.0, pitch: float = 0.0, roll: float = 0.0) -> np.ndarray:
    """Rotate real-SH coefficients [K, C] by ZYX Euler angles."""
    K = coeffs.shape[0]
    deg = int(math.isqrt(K)) - 1
    M = sh_rotation_matrix(euler_zyx_matrix(yaw, pitch, roll), deg)
    return (M @ coeffs.astype(np.float64)).astype(np.float32)
