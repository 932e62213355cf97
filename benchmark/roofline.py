"""The bound arithmetic of the per-layer metrics: the card's published peaks,
the float32 operations and bytes each kernel needs on its inputs, and the
operations of a whole training step or served frame.

Kernel counts are copied from the port's on-card check (its compositor,
segment-sum and permutation bounds, PERF.md "Bounds"): the compositor's work is
data-dependent and counted in (pixel, entry) pairs on the very inputs a launch
got (`pair_counts`, over the reference's frozen plain tile batch); the
memory-bound kernels count each input byte read once and each output byte
written once. The whole-step counts are lower bounds by construction: they
count only the float operations that the algorithm cannot avoid per live
Gaussian, per pixel and per pair (module constants below).
"""

from __future__ import annotations

import torch

from .reference import render as R

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
FP32_OPS_PER_S = 67e12         # H100 SXM data sheet, float32 outside the tensor cores

# Float ops of a visited (pixel, entry) pair that the compositor skips: power
# (5 multiplies, 5 adds) and its test; where power <= 0 also expf, alpha and
# its test. The terminating pair is counted as an alpha skip (a lower bound).
SKIP_POWER_OPS = 11
SKIP_ALPHA_OPS = 15

# Per live Gaussian, forward: the projection, EWA covariance, conic and rect
# (~110 multiplies and adds of `reference/render.project`); the shading
# (degree-4 SH basis ~75, band kernel 25 exp + 25, the 25 x 3 contraction 150,
# the irradiance ~40, normals and materials ~60, gamma and blend ~30).
PREPROCESS_OPS = 110
SHADE_OPS = 405
# Per live Gaussian row of the trained leaves (18 floats), Adam's update:
# 2 moment updates (3 ops each), bias correction (2), sqrt, add, divide, lr
# (4): 12 ops an element.
ADAM_OPS = 18 * 12
# Per pixel and channel of the loss stack: SSIM's five 11-tap separable blurs
# (5 x 2 x 11 x 2 = 220) and its map (~20); L1 and the masks (~6).
LOSS_OPS_PER_PIXEL_CHANNEL = 246
BACKWARD_FACTOR = 2            # a backward needs at least twice its forward's ops


def composite_ops_per_pair(C: int) -> int:
    """Forward ops per contributing pair: power (10) and the three tests, expf,
    alpha (multiply, min), T * (1 - alpha), w, 2 per channel: 25 at C = 3."""
    return 19 + 2 * C


def backward_ops_per_pair(C: int) -> int:
    """Backward ops per contributing pair: the forward's replay without the
    blend (19), c . gbar (2C), the prefix (2), dL/dalpha (5), dG, dx, dy, G dx,
    G dy (5), the six geometry terms (17), w gbar (C) and one add per gradient
    value of the pixel reduction (6 + C)."""
    return 54 + 4 * C


def compositor_ops(per_pair: int, pairs: dict) -> int:
    alpha_skips = pairs["visited"] - pairs["contributing"] - pairs["power_skipped"]
    return (per_pair * pairs["contributing"] + SKIP_POWER_OPS * pairs["power_skipped"]
            + SKIP_ALPHA_OPS * alpha_skips)


def bound_s(bytes_: float, ops: float) -> float:
    """The least time the card needs for `bytes_` of HBM traffic and `ops`
    float32 operations."""
    return max(bytes_ / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S)


@torch.no_grad()
def pair_counts(feat, tile_start, tile_end, grid_x: int, tile: int = 16) -> dict:
    """A compositor launch's data-dependent work in (pixel, entry) pairs:
    `visited` before each pixel terminates (the terminating pair included),
    of them `contributing` (blended) and `power_skipped` (power > 0, counted
    where exp(min(power, 0)) == 1: a count that errs low), and `entries_read`,
    the entry rows a tile needs before its last pixel terminates."""
    counts = tile_end - tile_start
    out = dict(visited=0, contributing=0, power_skipped=0, entries_read=0)
    for t0, t1, length in R.tile_batches(counts.cpu().numpy(), tile * tile):
        tids = torch.arange(t0, t1, device=feat.device)
        alpha, aux = R._tile_batch(feat, tile_start[t0:t1], counts[t0:t1], tids, grid_x, tile,
                                   length)
        _, p_prev, include, _, _ = R._transmittance(alpha)
        visited = (p_prev >= R.T_EPS) & aux["valid"][..., None]
        out["visited"] += int(visited.sum())
        out["entries_read"] += int(visited.any(dim=2).sum())
        out["contributing"] += int((visited & include & ~aux["skip"]).sum())
        out["power_skipped"] += int((visited & aux["skip"] & (aux["G"] == 1.0)).sum())
    return out


def composite_fwd_bound_s(pairs: dict, F: int, tiles: int, C: int) -> float:
    """Kernel B: the entry rows the tiles walk read, the tile ranges read, the
    tiles' colors and final transmittance written."""
    P = 256
    return bound_s(pairs["entries_read"] * F * 4 + tiles * 2 * 8 + C * 4 + tiles * P * (C + 1) * 4,
                   compositor_ops(composite_ops_per_pair(C), pairs))


def composite_bwd_bound_s(pairs: dict, entries: int, F: int, tiles: int, C: int) -> float:
    """Kernel C: the walked entry rows and the cotangents read, every entry's
    gradient row written."""
    P = 256
    return bound_s((pairs["entries_read"] + entries) * F * 4 + tiles * 2 * 8
                   + tiles * P * (C + 3) * 4,
                   compositor_ops(backward_ops_per_pair(C), pairs))


def permute_bound_s(entries: int, slots: int) -> float:
    """Kernel P: perm and gid read for each real entry, gauss_id and slot_pos
    written for each slot."""
    return bound_s(entries * (8 + 4) + slots * (4 + 4), 0)


def segment_sum_bound_s(entries: int, F: int, n: int) -> float:
    """Kernel D: the real entries' rows and ids read once, the Gaussian rows
    written once; one add per entry value."""
    return bound_s(entries * (F * 4 + 4) + n * F * 4, entries * F)


def train_step_ops(pairs: dict, C: int, live: int, pixels: int) -> float:
    """Float ops one training step needs: the compositor forward and backward on
    its pairs, preprocess and shading forward and backward and Adam per live
    Gaussian, the loss stack forward and backward per pixel."""
    per_gauss = (PREPROCESS_OPS + SHADE_OPS) * (1 + BACKWARD_FACTOR) + ADAM_OPS
    return (compositor_ops(composite_ops_per_pair(C), pairs)
            + compositor_ops(backward_ops_per_pair(C), pairs)
            + per_gauss * live + LOSS_OPS_PER_PIXEL_CHANNEL * 3 * (1 + BACKWARD_FACTOR) * pixels)


def frame_ops(pairs: dict, live: int, mlp_params: int) -> float:
    """Float ops one served frame needs: the MLP (2 per weight), preprocess and
    shading per live Gaussian, the compositor forward at C = 3."""
    return (2 * mlp_params + (PREPROCESS_OPS + SHADE_OPS) * live
            + compositor_ops(composite_ops_per_pair(3), pairs))
