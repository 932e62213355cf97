"""Gaussian parameter pool with the sky parameterization: port of the JAX
package's `models/gaussians.py` (pool layout, activations, construction).

The pool has a fixed capacity with an `alive` mask; foreground and sky Gaussians
share rows, and `is_sky` selects between `xyz` and the sphere parameterization
(theta, phi, radius, center). The training step adds the densification
statistics and the opacity reset; densify, prune and grow arrive with the
trainer.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..utils.general import (
    inverse_sigmoid,
    get_minimum_axis,
    flip_align_view,
    cartesian_to_polar,
    polar_to_cartesian,
)
from ..utils.graphics import quat_to_rotmat, safe_normalize

DEFAULT_ALBEDO = 1.0      # pre-sigmoid logits
DEFAULT_ROUGHNESS = 1.0
DEFAULT_METALNESS = 0.1
INIT_OPACITY = float(inverse_sigmoid(torch.tensor(0.1, dtype=torch.float64)))  # logit of 0.1


class GaussianParams(NamedTuple):
    """Optimizable leaves, all [cap, ...]. Rows beyond `alive` are inert."""
    xyz: torch.Tensor        # [cap, 3] world position (foreground rows)
    albedo: torch.Tensor     # [cap, 3] pre-sigmoid
    opacity: torch.Tensor    # [cap, 1] pre-sigmoid
    scaling: torch.Tensor    # [cap, 3] log-scale
    rotation: torch.Tensor   # [cap, 4] unnormalized quaternion (w, x, y, z)
    roughness: torch.Tensor  # [cap, 1] pre-sigmoid
    metalness: torch.Tensor  # [cap, 1] pre-sigmoid
    sky_angles: torch.Tensor # [cap, 2] (theta, phi) (sky rows)
    sky_radius: torch.Tensor # [] scalar


class GaussianState(NamedTuple):
    """Non-optimized pool state."""
    alive: torch.Tensor           # [cap] bool
    is_sky: torch.Tensor          # [cap] bool
    sky_center: torch.Tensor      # [3]
    max_radii2d: torch.Tensor     # [cap] float
    xyz_grad_accum: torch.Tensor  # [cap] float
    denom: torch.Tensor           # [cap] float


def to_device(tup, device):
    """A NamedTuple of tensors with every field on `device`."""
    return type(tup)(*[a.to(device) for a in tup])


# --------------------------------------------------------------------- activations


def get_scaling(p: GaussianParams) -> torch.Tensor:
    return torch.exp(p.scaling)


def get_rotation(p: GaussianParams) -> torch.Tensor:
    return safe_normalize(p.rotation)


def get_opacity(p: GaussianParams, s: GaussianState) -> torch.Tensor:
    # Dead rows get exactly 0 opacity -> the alpha < 1/255 skip culls them.
    return torch.sigmoid(p.opacity) * s.alive[:, None]


def get_albedo(p: GaussianParams) -> torch.Tensor:
    return torch.sigmoid(p.albedo)


def get_roughness(p: GaussianParams) -> torch.Tensor:
    return torch.sigmoid(p.roughness)


def get_metalness(p: GaussianParams) -> torch.Tensor:
    return torch.sigmoid(p.metalness)


def get_sky_angles(p: GaussianParams) -> torch.Tensor:
    """Clamp theta to [0, pi/2], phi to [-pi/2, pi/2]."""
    theta = torch.clamp(p.sky_angles[:, 0], 0.0, np.pi / 2)
    phi = torch.clamp(p.sky_angles[:, 1], -np.pi / 2, np.pi / 2)
    return torch.stack([theta, phi], dim=-1)


def get_xyz(p: GaussianParams, s: GaussianState) -> torch.Tensor:
    """Merge of foreground xyz and sphere-parameterized sky xyz."""
    sky_xyz = polar_to_cartesian(get_sky_angles(p), s.sky_center, p.sky_radius)
    return torch.where(s.is_sky[:, None], sky_xyz, p.xyz)


def get_normal(p: GaussianParams, dir_pp_normalized: torch.Tensor | None = None) -> torch.Tensor:
    """Shortest-covariance-axis normal, flipped toward the viewer."""
    R = quat_to_rotmat(get_rotation(p))
    n = get_minimum_axis(get_scaling(p), R)
    if dir_pp_normalized is not None:
        n, _ = flip_align_view(n, dir_pp_normalized)
    return n


# ------------------------------------------------------------------- construction


def init_from_points(points: np.ndarray, knn_dist2: np.ndarray, capacity: int,
                     device: str | torch.device = "cpu") -> tuple[GaussianParams, GaussianState]:
    """Initialize the pool from a point cloud: isotropic log-scales from the mean
    3-NN squared distance, identity rotations, opacity 0.1.

    Args:
        points: [N, 3].
        knn_dist2: [N] mean squared distance to the 3 nearest neighbours.
        capacity: pool size (>= N).
    """
    n = points.shape[0]
    if capacity < n:
        raise ValueError(f"capacity {capacity} < {n} points")

    def full(val, shape):
        a = np.zeros((capacity,) + shape, dtype=np.float32)
        a[:n] = val
        return torch.as_tensor(a, device=device)

    scales = np.log(np.sqrt(np.maximum(knn_dist2, 1e-7)))[:, None].repeat(3, axis=1)
    rot = np.zeros((n, 4), dtype=np.float32)
    rot[:, 0] = 1.0
    params = GaussianParams(
        xyz=full(points.astype(np.float32), (3,)),
        albedo=full(DEFAULT_ALBEDO, (3,)),
        opacity=full(INIT_OPACITY, (1,)),
        scaling=full(scales.astype(np.float32), (3,)),
        rotation=full(rot, (4,)),
        roughness=full(DEFAULT_ROUGHNESS, (1,)),
        metalness=full(DEFAULT_METALNESS, (1,)),
        sky_angles=torch.zeros((capacity, 2), dtype=torch.float32, device=device),
        sky_radius=torch.tensor(1.0, dtype=torch.float32, device=device),
    )
    alive = torch.zeros(capacity, dtype=torch.bool, device=device)
    alive[:n] = True
    zeros = lambda: torch.zeros(capacity, dtype=torch.float32, device=device)
    state = GaussianState(
        alive=alive,
        is_sky=torch.zeros(capacity, dtype=torch.bool, device=device),
        sky_center=torch.zeros(3, dtype=torch.float32, device=device),
        max_radii2d=zeros(),
        xyz_grad_accum=zeros(),
        denom=zeros(),
    )
    return params, state


def augment_with_sky(params: GaussianParams, state: GaussianState,
                     sky_points: np.ndarray, sky_knn_dist2: np.ndarray,
                     sky_radius: float, sky_center: np.ndarray) -> tuple[GaussianParams, GaussianState]:
    """Append sky Gaussians on the hemisphere shell after the live rows."""
    device = state.alive.device
    cap = state.alive.shape[0]
    n0 = int(state.alive.sum())
    m = sky_points.shape[0]
    if n0 + m > cap:
        raise ValueError(f"{n0} live + {m} sky rows exceed capacity {cap}")
    sl = slice(n0, n0 + m)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)

    angles = cartesian_to_polar(f32(sky_points), f32(sky_center), sky_radius)
    scales = np.log(np.sqrt(np.maximum(sky_knn_dist2, 1e-7)))[:, None].repeat(3, axis=1)
    rot = np.zeros((m, 4), dtype=np.float32)
    rot[:, 0] = 1.0

    def upd(arr, val):
        arr = arr.clone()
        arr[sl] = val
        return arr

    params = params._replace(
        opacity=upd(params.opacity, INIT_OPACITY),
        scaling=upd(params.scaling, f32(scales)),
        rotation=upd(params.rotation, f32(rot)),
        sky_angles=upd(params.sky_angles, angles),
        sky_radius=torch.tensor(float(sky_radius), dtype=torch.float32, device=device),
    )
    state = state._replace(alive=upd(state.alive, True), is_sky=upd(state.is_sky, True),
                           sky_center=f32(sky_center))
    return params, state


# -------------------------------------------------------------- density control


def add_densification_stats(state: GaussianState, mean2d_grad_ndc: torch.Tensor,
                            visible: torch.Tensor, radii: torch.Tensor) -> GaussianState:
    """Accumulate ||dL/dmean2D|| (NDC units) over visible live Gaussians and track
    the largest screen radius."""
    norm = torch.linalg.vector_norm(mean2d_grad_ndc[:, :2], dim=-1)
    upd = visible & state.alive
    return state._replace(
        xyz_grad_accum=state.xyz_grad_accum + torch.where(upd, norm, 0.0),
        denom=state.denom + upd.to(state.denom.dtype),
        max_radii2d=torch.where(upd, torch.maximum(state.max_radii2d, radii.to(torch.float32)),
                                state.max_radii2d),
    )


def reset_opacity(params: GaussianParams, opt_moments):
    """Clamp opacity to <= 0.01 and zero its optimizer moments.

    opt_moments: a tuple of moment trees; the GaussianParams among them get a
    zero opacity moment, the others pass through."""
    new_op = inverse_sigmoid(torch.clamp_max(torch.sigmoid(params.opacity), 0.01))
    params = params._replace(opacity=new_op)
    opt_moments = tuple(
        m._replace(opacity=torch.zeros_like(m.opacity)) if isinstance(m, GaussianParams) else m
        for m in opt_moments)
    return params, opt_moments


def num_alive(state: GaussianState) -> torch.Tensor:
    return torch.sum(state.alive)
