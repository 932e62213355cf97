"""General math helpers: port of the JAX package's `utils/general.py`. Random sampling takes an explicit
`torch.Generator`, or the uniform draws themselves, never torch's global RNG."""

from __future__ import annotations

import math

import numpy as np
import torch


def inverse_sigmoid(x):
    return torch.log(x / (1 - x))


def grad_thr_exp_scheduling(it, max_iter, grad_thr_start, grad_thr_end=0.0004):
    """Log-linear anneal of the densification gradient threshold."""
    t = it / max_iter
    return float(np.exp(np.log(grad_thr_start) * (1 - t) + np.log(grad_thr_end) * t))


def sample_points_on_unit_hemisphere(num_points: int, generator: torch.Generator | None = None,
                                     draws=None) -> torch.Tensor:
    """Points on the upper part of the unit hemisphere in COLMAP coordinates (y
    down): y in [-0.5, 0), phi in [-pi/4, pi/4]; seeds the sky Gaussians.

    The two uniform [0, 1) draws of length num_points come from `generator`
    (on its device), or are given as `draws` = (u_y, u_phi)."""
    if draws is None:
        dev = generator.device if generator is not None else "cpu"
        u_y = torch.rand((num_points,), generator=generator, device=dev)
        u_phi = torch.rand((num_points,), generator=generator, device=dev)
    else:
        u_y, u_phi = (torch.as_tensor(np.array(d, np.float32)) for d in draws)
    y = -0.5 * u_y
    theta = torch.arccos(y)
    phi = (math.pi / 2) * u_phi - math.pi / 4
    x = torch.sin(phi) * torch.sin(theta)
    z = torch.sin(theta) * torch.cos(phi)
    return torch.stack([x, y, z], dim=-1)


def fibonacci_sphere(num_points: int) -> np.ndarray:
    """Points spread evenly over the unit sphere by the Fibonacci lattice
    (host numpy, float32 [num_points, 3])."""
    phi = math.pi * (3.0 - math.sqrt(5.0))
    N = (num_points - 1) / 2
    i = np.linspace(-N, N, num_points, dtype=np.float64)
    lat = np.arcsin(2.0 * i / (2 * N + 1))
    lon = phi * i
    x = np.cos(lon) * np.cos(lat)
    y = np.sin(lon) * np.cos(lat)
    z = np.sin(lat)
    return np.stack([x, y, z], axis=-1).astype(np.float32)


def rand_hemisphere_dir(rand, N: int, n: torch.Tensor) -> torch.Tensor:
    """Cosine-weighted random directions on the hemispheres around normals n
    [L, 3]: [L, N, 3]. `rand` is the uniform [0, 1) draws [L, N, 3], or a
    `torch.Generator` that draws them (on n's device)."""
    L = n.shape[0]
    if isinstance(rand, torch.Generator):
        rand = torch.rand((L, N, 3), generator=rand, device=rand.device).to(n.device)
    normals = torch.broadcast_to(n[:, None, :], (L, N, 3))
    phi = 2 * math.pi * rand[..., 1]
    d0 = torch.cos(phi) * torch.sqrt(rand[..., 0])
    d1 = torch.sin(phi) * torch.sqrt(rand[..., 0])
    d2 = torch.sqrt(torch.clamp(1.0 - d0 * d0 - d1 * d1, 0.0, 1.0))
    tangent = rand / (torch.linalg.vector_norm(rand, dim=-1, keepdim=True) + 1e-12)
    bitangent = torch.linalg.cross(tangent, normals, dim=-1)
    return tangent * d0[..., None] + bitangent * d1[..., None] + normals * d2[..., None]


def expon_lr(step, lr_init, lr_final, lr_delay_steps=0, lr_delay_mult=1.0,
             max_steps=1_000_000) -> torch.Tensor:
    """Log-lerp (exponential) lr schedule with an optional sine-eased delay, as a
    float32 tensor on `step`'s device; 0 when lr_init == lr_final == 0."""
    step = torch.as_tensor(step).to(torch.float32)
    if lr_init == 0.0 and lr_final == 0.0:
        return torch.zeros_like(step)
    if lr_delay_steps > 0:
        delay_rate = lr_delay_mult + (1 - lr_delay_mult) * torch.sin(
            0.5 * math.pi * torch.clamp(step / lr_delay_steps, 0, 1))
    else:
        delay_rate = 1.0
    t = torch.clamp(step / max_steps, 0, 1)
    log_lerp = torch.exp(math.log(lr_init) * (1 - t) + math.log(lr_final) * t)
    return torch.where(step < 0, 0.0, delay_rate * log_lerp)


def get_minimum_axis(scales: torch.Tensor, R: torch.Tensor) -> torch.Tensor:
    """Column of R for the smallest scale (first minimum wins, like argmin).

    Args:
        scales: [N, 3] positive scales.
        R: [N, 3, 3] rotation matrices (columns = principal axes).
    Returns:
        [N, 3]
    """
    s0, s1, s2 = scales[..., 0:1], scales[..., 1:2], scales[..., 2:3]
    c0, c1, c2 = R[..., 0], R[..., 1], R[..., 2]
    first01 = s0 <= s1
    ax01 = torch.where(first01, c0, c1)
    s01 = torch.where(first01, s0, s1)
    return torch.where(s01 <= s2, ax01, c2)


def flip_align_view(normal: torch.Tensor, viewdir: torch.Tensor):
    """Flip normals to face the camera (viewdir points from camera to point)."""
    dotprod = torch.sum(normal * -viewdir, dim=-1, keepdim=True)
    non_flip = dotprod >= 0
    return torch.where(non_flip, normal, -normal), non_flip


def cartesian_to_polar(xyz: torch.Tensor, center: torch.Tensor, radius) -> torch.Tensor:
    """(theta, phi) sky-sphere angles of points on a sphere (COLMAP coords, y down)."""
    theta = torch.arccos(torch.clamp((-xyz[..., 1] + center[1]) / radius, -1, 1))
    phi = torch.arctan2(xyz[..., 0] - center[0], xyz[..., 2] - center[2])
    return torch.stack([theta, phi], dim=-1)


def polar_to_cartesian(angles: torch.Tensor, center: torch.Tensor, radius) -> torch.Tensor:
    """Inverse of cartesian_to_polar: sky (theta, phi) -> xyz on the sky sphere."""
    theta, phi = angles[..., 0], angles[..., 1]
    x = radius * torch.sin(theta) * torch.sin(phi) + center[0]
    y = -radius * torch.cos(theta) + center[1]
    z = radius * torch.sin(theta) * torch.cos(phi) + center[2]
    return torch.stack([x, y, z], dim=-1)
