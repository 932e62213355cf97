"""k-nearest-neighbour mean squared distance for the Gaussian scale
initialisation: port of the JAX package's `ops/knn.py`.

`knn_dist2` is host code, run once per scene by the trainer: the native C++
box-pruned 3-NN (`native.py`) when the library builds, else scipy's cKDTree.
Both are exact. `knn_dist2_morton` is the on-device approximate version
(JAX's `knn_dist2_jax`), a library function for points already on the card.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import native


def knn_dist2(points: np.ndarray, k: int = 3) -> np.ndarray:
    """Mean squared distance from each point to its k nearest neighbours (exact)."""
    if k <= 8 and native.get_lib() is not None:
        return native.knn_mean_dist2_native(np.asarray(points), k)
    from scipy.spatial import cKDTree

    tree = cKDTree(points)
    d, _ = tree.query(points, k=k + 1)  # the first neighbour is the point itself
    return (d[:, 1:] ** 2).mean(axis=1).astype(np.float32)


def _morton_codes(pts01: torch.Tensor) -> torch.Tensor:
    """10 bits per axis of clip(pts01 * 1023, 0, 1023), truncated, interleaved
    into a 30-bit Morton code (simple_knn.cu:45-70); int64 (torch sorts
    unsigned 32-bit integers poorly)."""
    q = torch.clamp(pts01 * 1023.0, 0, 1023).to(torch.int64)

    def spread(x):
        x = (x | (x << 16)) & 0x030000FF
        x = (x | (x << 8)) & 0x0300F00F
        x = (x | (x << 4)) & 0x030C30C3
        x = (x | (x << 2)) & 0x09249249
        return x

    return spread(q[:, 0]) | (spread(q[:, 1]) << 1) | (spread(q[:, 2]) << 2)


def knn_dist2_morton(points: torch.Tensor, k: int = 3, window: int = 32,
                     mask: torch.Tensor | None = None) -> torch.Tensor:
    """Approximate mean squared k-NN distance on the points' device: the JAX
    package's `knn_dist2_jax`.

    The candidates of a point are its `window` predecessors and successors in
    Morton order (a stable sort of the codes), the locality the reference's
    1024-point boxes exploit. Near the ends the clipped candidate index
    repeats, so one neighbour can fill several of the k smallest, as in JAX.

    Args:
        points: [N, 3].
        mask: optional [N] bool; masked-out points are no candidates (their
            code sorts last, their distance is inf) and get 0.
    Returns:
        [N] mean of the k smallest squared candidate distances.
    """
    n = points.shape[0]
    if mask is not None:
        lo = torch.where(mask[:, None], points, torch.inf).amin(dim=0)
        hi = torch.where(mask[:, None], points, -torch.inf).amax(dim=0)
    else:
        lo, hi = points.amin(dim=0), points.amax(dim=0)
    pts01 = (points - lo) / torch.clamp_min(hi - lo, 1e-9)
    codes = _morton_codes(pts01)
    if mask is not None:
        codes = torch.where(mask, codes, 0xFFFFFFFF)
    order = torch.sort(codes, stable=True).indices
    sorted_pts = points[order]
    i = torch.arange(n, device=points.device)
    offs = torch.cat([torch.arange(-window, 0), torch.arange(1, window + 1)]).to(points.device)
    d2 = torch.empty((n, 2 * window), dtype=points.dtype, device=points.device)
    valid = mask[order] if mask is not None else None
    for c, o in enumerate(offs.tolist()):
        j = torch.clamp(i + o, 0, n - 1)
        d = torch.sum((sorted_pts[j] - sorted_pts) ** 2, dim=-1)
        d = torch.where(j == i, torch.inf, d)
        if valid is not None:
            d = torch.where(valid[j], d, torch.inf)
        d2[:, c] = d
    d2_sorted = torch.topk(d2, k, dim=-1, largest=False).values.mean(dim=-1)
    out = torch.zeros(n, dtype=points.dtype, device=points.device)
    out[order] = d2_sorted
    if mask is not None:
        out = torch.where(mask, out, 0.0)
    return out
