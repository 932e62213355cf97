"""Gaussian parameter pool with the sky parameterization: port of the JAX
package's `models/gaussians.py` (pool layout, activations, construction).

The pool has a fixed capacity with an `alive` mask; foreground and sky Gaussians
share rows, and `is_sky` selects between `xyz` and the sphere parameterization
(theta, phi, radius, center). Density control works inside the pool: clone and
split write into free rows, prune clears `alive`, and the matching rows of the
optimizer moments are zeroed; when the pool is full the densify report counts
what did not fit and the trainer grows the pool (`grow`). Every step of it is
fixed-size tensor work, with no host sync.
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


def pad_rows(a: torch.Tensor, new_capacity: int) -> torch.Tensor:
    """A pool leaf padded with zero rows to `new_capacity` (scalars as they are)."""
    if a.ndim == 0:
        return a
    if new_capacity < a.shape[0]:
        raise ValueError(f"new capacity {new_capacity} < {a.shape[0]}")
    return torch.cat([a, a.new_zeros((new_capacity - a.shape[0],) + a.shape[1:])], dim=0)


def grow(params: GaussianParams, state: GaussianState, new_capacity: int):
    """Pad the pool to `new_capacity` rows of zeros (dead rows)."""
    return (GaussianParams(*[pad_rows(a, new_capacity) for a in params]),
            state._replace(**{k: pad_rows(getattr(state, k), new_capacity) for k in
                              ("alive", "is_sky", "max_radii2d", "xyz_grad_accum", "denom")}))


# -------------------------------------------------------------- density control


class DensifyReport(NamedTuple):
    n_cloned: torch.Tensor
    n_split: torch.Tensor
    n_pruned: torch.Tensor
    overflow: torch.Tensor  # selected but not allocated: the pool was full


def _nonzero_padded(mask: torch.Tensor) -> torch.Tensor:
    """Indices of the True rows in order, padded to len(mask) with len(mask)
    (jnp.nonzero(size=cap, fill_value=cap)), with no host sync."""
    cap = mask.shape[0]
    idx = torch.argsort((~mask).to(torch.int8), stable=True)
    return torch.where(torch.arange(cap, device=mask.device) < mask.sum(), idx, cap)


def _allocate_slots(free: torch.Tensor, want: torch.Tensor):
    """Pair the `want` rows with `free` rows, in order. Returns (src_idx [cap],
    dst_idx [cap], count): the first `count` pairs are copies to make; the rest
    point at row `cap`, which the writes below skip."""
    count = torch.minimum(free.sum(), want.sum())
    return _nonzero_padded(want), _nonzero_padded(free), count


def _scatter_rows(a: torch.Tensor, dst: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """a with a[dst[i]] = rows[i], skipping dst[i] == len(a) (JAX's .at[].set
    mode="drop"): the skipped rows land on a scratch row that is cut off."""
    out = torch.cat([a, a[:1]], dim=0)
    out[dst] = rows.to(a.dtype)
    return out[:-1]


def _copy_rows(tree, src_idx, dst_idx, count, transform=None):
    """tree[dst_idx[i]] = transform(tree)[src_idx[i]] for i < count."""
    cap = src_idx.shape[0]
    dst = torch.where(torch.arange(cap, device=src_idx.device) < count, dst_idx, cap)
    src = torch.clamp(src_idx, 0, cap - 1)
    ta_tree = tree if transform is None else transform
    return type(tree)(*[a if a.ndim == 0 else _scatter_rows(a, dst, ta[src])
                        for a, ta in zip(tree, ta_tree)])


def _zero_rows(tree, dst_idx, count):
    cap = dst_idx.shape[0]
    dst = torch.where(torch.arange(cap, device=dst_idx.device) < count, dst_idx, cap)
    return type(tree)(*[a if a.ndim == 0 else _scatter_rows(a, dst, a.new_zeros((cap,) + a.shape[1:]))
                        for a in tree])


def _zero_selected(tree, sel):
    return type(tree)(*[a if a.ndim == 0 else
                        torch.where(sel.reshape((-1,) + (1,) * (a.ndim - 1)), 0.0, a)
                        for a in tree])


@torch.no_grad()
def densify_and_prune(params: GaussianParams, state: GaussianState, opt_moments,
                      grad_threshold, min_opacity: float, extent, max_screen_size,
                      percent_dense: float = 0.01, n_split: int = 2,
                      generator: torch.Generator | None = None,
                      noise: torch.Tensor | None = None):
    """Clone small and split large high-gradient Gaussians, then prune: the JAX
    package's `densify_and_prune` over the fixed pool, op for op.

    Args:
        opt_moments: tuple of GaussianParams-shaped trees (Adam's mu, nu) whose
            rows are zeroed where new Gaussians land and where sources split.
        max_screen_size: None, or the screen-radius prune threshold (which
            never fires: the stats are reset before the prune, as in the
            reference).
        generator / noise: the split samples' standard-normal draws
            [n_split, cap, 3] come from `generator` (on the pool's device), or
            are given as `noise`.
    Returns:
        (params, state, opt_moments, DensifyReport)
    """
    dev = state.alive.device
    cap = state.alive.shape[0]
    ar = torch.arange(cap, device=dev)
    grads = torch.where(state.denom > 0,
                        state.xyz_grad_accum / torch.clamp_min(state.denom, 1), 0.0)
    scaling = get_scaling(params)
    max_scale = torch.max(scaling, dim=-1).values
    xyz_all = get_xyz(params, state)

    # Clone (small Gaussians): copy the row verbatim.
    clone_sel = (grads >= grad_threshold) & (max_scale <= percent_dense * extent) & state.alive
    src_c, dst_c, cnt_c = _allocate_slots(~state.alive, clone_sel)
    params = _copy_rows(params, src_c, dst_c, cnt_c)
    dmask = torch.where(ar < cnt_c, dst_c, cap)
    state = state._replace(
        alive=_scatter_rows(state.alive, dmask, torch.ones(cap, dtype=torch.bool, device=dev)),
        is_sky=_scatter_rows(state.is_sky, dmask, state.is_sky[torch.clamp(src_c, 0, cap - 1)]))
    opt_moments = tuple(_zero_rows(m, dst_c, cnt_c) for m in opt_moments)

    # Split (large Gaussians): n_split samples from the Gaussian with scale /
    # (0.8 n_split); n_split - 1 new rows, and the source row becomes the last
    # sample in place.
    split_sel = (grads >= grad_threshold) & (max_scale > percent_dense * extent) & state.alive
    R = quat_to_rotmat(get_rotation(params))
    if noise is None:
        noise = torch.randn((n_split, cap, 3), generator=generator, device=dev)
    noise = noise.to(dev) * scaling[None]
    samples = torch.einsum("nij,snj->sni", R, noise) + xyz_all[None]      # [S, cap, 3]
    # Sky samples go back onto the sphere at its true radius (the reference
    # converts back with radius 1).
    center = state.sky_center[None, None, :]
    rel = samples - center
    rel_n = rel * torch.rsqrt(torch.clamp_min(torch.sum(rel * rel, dim=-1, keepdim=True), 1e-20))
    sky_proj = center + params.sky_radius * rel_n
    sky_samples = cartesian_to_polar(sky_proj, state.sky_center, params.sky_radius)
    new_scaling = torch.log(scaling / (0.8 * n_split))

    n_split_sel = split_sel.sum()
    n_split_alloc = torch.zeros((), dtype=n_split_sel.dtype, device=dev)
    free_after_clone = ~state.alive
    for s in range(n_split - 1):
        split_params = params._replace(
            xyz=samples[s],
            sky_angles=torch.where(state.is_sky[:, None], sky_samples[s], params.sky_angles),
            scaling=new_scaling)
        src_s, dst_s, cnt_s = _allocate_slots(free_after_clone, split_sel)
        params = _copy_rows(params, src_s, dst_s, cnt_s, transform=split_params)
        dmask = torch.where(ar < cnt_s, dst_s, cap)
        state = state._replace(
            alive=_scatter_rows(state.alive, dmask,
                                torch.ones(cap, dtype=torch.bool, device=dev)),
            is_sky=_scatter_rows(state.is_sky, dmask,
                                 state.is_sky[torch.clamp(src_s, 0, cap - 1)]))
        opt_moments = tuple(_zero_rows(m, dst_s, cnt_s) for m in opt_moments)
        free_after_clone = _scatter_rows(free_after_clone, dmask,
                                         torch.zeros(cap, dtype=torch.bool, device=dev))
        n_split_alloc = n_split_alloc + cnt_s
    last = n_split - 1
    params = params._replace(
        xyz=torch.where(split_sel[:, None], samples[last], params.xyz),
        sky_angles=torch.where((split_sel & state.is_sky)[:, None], sky_samples[last],
                               params.sky_angles),
        scaling=torch.where(split_sel[:, None], new_scaling, params.scaling))
    opt_moments = tuple(_zero_selected(m, split_sel) for m in opt_moments)

    # Reset the stats BEFORE pruning: the reference's densification_postfix
    # zeroes max_radii2D, so the screen-size prune below compares against zeros
    # and never fires (kept for parity).
    state = state._replace(xyz_grad_accum=torch.zeros_like(state.xyz_grad_accum),
                           denom=torch.zeros_like(state.denom),
                           max_radii2d=torch.zeros_like(state.max_radii2d))

    opa = get_opacity(params, state)[:, 0]
    prune = (opa < min_opacity) & state.alive
    if max_screen_size is not None:
        prune = (prune | (state.max_radii2d > max_screen_size)
                 | (torch.max(get_scaling(params), dim=-1).values > 0.1 * extent))
        prune = prune & state.alive
    state = state._replace(alive=state.alive & ~prune)

    overflow = (clone_sel.sum() - cnt_c) + ((n_split - 1) * n_split_sel - n_split_alloc)
    report = DensifyReport(n_cloned=cnt_c, n_split=n_split_sel, n_pruned=prune.sum(),
                           overflow=overflow)
    return params, state, opt_moments, report


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
