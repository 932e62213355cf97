"""Tile binning: entry expansion, one (tile, depth) sort, per-tile ranges.

Port of the JAX package's `ops/binning.py` `bin_gaussians` /
`bin_gaussians_aligned`, itself the reference's `duplicateWithKeys` + radix sort +
`identifyTileRanges`. The flow is expand -> one stable sort -> tile ranges:

* Gaussians are ranked by a stable depth argsort (ties by index, as the
  reference's stable radix sort over positive depths orders them);
* per-Gaussian entry offsets are the exclusive cumsum of the entry counts;
* the expansion (`expand_entries`, a CUDA kernel on the card, the plain version
  below on the CPU) writes, per entry slot, the int64 key (tile << 32) | rank
  and the Gaussian id. It walks each Gaussian's tile rect row-major or, with
  row intervals (`preprocess.row_intervals`), the per-row ellipse intervals of
  its first 8 tile rows and then the full rect width below them;
* one stable sort of the keys gives every tile's entries in depth order, and
  the tile ranges (and so the per-tile counts) come from a binary search of
  the sorted keys;
* the layout the gather's gradient sums over (`ops/segment_sum.py`): Gaussian
  g's slots are offsets[g] .. offsets[g] + counts[g] (clamped to the budget),
  and the inverse of the sort permutation gives each slot's sorted position
  (`permute_entries`, a CUDA kernel on the card, which also gathers the sorted
  ids), so the backward sorts nothing.

The depth argsort, the expansion and the key sort run inside the
`torch.profiler` range "binning.sort" (nested in the rasterizer's
"rasterize.binning"): the expansion lies between the two sorts, as the rank
it writes into the keys comes from the first.

The JAX package's chunk-aligned layout and its tile histograms exist for the
TPU's DMA and have no counterpart here.

The entry budget `max_dup` is static, as in the JAX package: entries past it are
dropped and `overflow` says how many.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .cuda import expand as _expand_kernel
from .cuda import segment_sum as _segment_sum_kernel
from .preprocess import H_CAP, PreprocessOut

KEY_INVALID = torch.iinfo(torch.int64).max  # key of every unwritten slot


class BinningOut(NamedTuple):
    gauss_id: torch.Tensor    # [max_dup] int32 source Gaussian per sorted entry
    tile_start: torch.Tensor  # [num_tiles] int64 first entry of each tile
    tile_end: torch.Tensor    # [num_tiles] int64 one-past-last entry of each tile
    num_entries: torch.Tensor # [] int64 entries before the budget clamp
    overflow: torch.Tensor    # [] int64 entries dropped by the budget (0 = exact)
    seg_bounds: torch.Tensor  # [N + 1] int64: Gaussian g's pre-sort slots are
                              # seg_bounds[g] .. seg_bounds[g + 1] (budget-clamped)
    slot_pos: torch.Tensor    # [max_dup] int32 sorted position of each pre-sort slot


def expand_entries_plain(counts: torch.Tensor, offsets: torch.Tensor,
                         rect_min: torch.Tensor, rect_w: torch.Tensor,
                         rank: torch.Tensor, grid_x: int, max_dup: int,
                         packed: torch.Tensor | None = None):
    """Plain version of the expansion kernels (`csrc/expand.cu`).

    Args:
        counts: [N] int32 entries per Gaussian (tiles_touched, or the interval
            counts when `packed` is given).
        offsets: [N] int64 exclusive cumsum of counts.
        rect_min: [N, 2] int32 first tile (tx, ty) of each rect.
        rect_w: [N] int32 rect width in tiles (>= 1).
        rank: [N] int64 depth rank.
        packed: optional [H_CAP, N] int32 per-row intervals txl_rel + 128 * w_j:
            the Gaussian's first H_CAP tile rows emit w_j tiles from column
            rect_x0 + txl_rel, the rows below the full rect width.
    Returns:
        keys [max_dup] int64 = (tile << 32) | rank, KEY_INVALID where unwritten;
        gid [max_dup] int32, 0 where unwritten.
    """
    dev = counts.device
    n = counts.shape[0]
    keys = torch.full((max_dup,), KEY_INVALID, dtype=torch.int64, device=dev)
    gid = torch.zeros((max_dup,), dtype=torch.int32, device=dev)
    g = torch.repeat_interleave(torch.arange(n, device=dev), counts.long())[:max_dup]
    slot = torch.arange(g.shape[0], device=dev) - offsets[g]
    w = rect_w[g].long()
    if packed is None:
        row = slot // w
        col = slot - row * w
    else:
        p = packed.long()
        w_j, txl = p >> 7, p & 127                   # [H_CAP, N]
        incl = torch.cumsum(w_j, dim=0)              # inclusive prefix over rows
        c8 = incl[-1][g]
        # The interval row holding the slot: rows with w_j = 0 add nothing to
        # the prefix, so they are stepped over.
        row8 = (slot[None, :] >= incl[:, g]).sum(dim=0)
        r8 = row8.clamp_max(H_CAP - 1)
        col8 = txl[r8, g] + slot - (incl[r8, g] - w_j[r8, g])
        tail = slot - c8                             # full-width rows below H_CAP
        q = tail // w
        in_cap = slot < c8
        row = torch.where(in_cap, row8, H_CAP + q)
        col = torch.where(in_cap, col8, tail - q * w)
    tile = (rect_min[g, 1].long() + row) * grid_x + rect_min[g, 0].long() + col
    keys[: g.shape[0]] = (tile << 32) | rank[g]
    gid[: g.shape[0]] = g.to(torch.int32)
    return keys, gid


def permute_entries_plain(gid: torch.Tensor, perm: torch.Tensor):
    """Plain version of the permutation kernel (`ops/cuda/segment_sum.py`
    `permute_entries`): the sorted entries' ids gid[perm] and the inverse of
    the sort permutation as int32, each pre-sort slot's sorted position."""
    D = perm.shape[0]
    slot_pos = torch.empty((D,), dtype=torch.int32, device=perm.device).scatter_(
        0, perm, torch.arange(D, dtype=torch.int32, device=perm.device))
    return gid[perm], slot_pos


def bin_gaussians(pre: PreprocessOut, grid_x: int, grid_y: int, max_dup: int,
                  intervals=None) -> BinningOut:
    """The depth-sorted per-tile entry list within a static budget of `max_dup`.

    intervals: optional (counts, packed) from `preprocess.row_intervals`. As in
    the JAX package they are used only while the grid is under 128 x 128 tiles
    and the pool under 2^24 rows; otherwise the rects are walked.
    """
    n = pre.depth.shape[0]
    dev = pre.depth.device
    num_tiles = grid_x * grid_y
    use_intervals = intervals is not None and grid_x < 128 and grid_y < 128 and n < (1 << 24)

    counts = (intervals[0] if use_intervals else pre.tiles_touched).to(torch.int32).contiguous()
    csum = torch.cumsum(counts, dim=0, dtype=torch.int64)
    offsets = csum - counts
    total = csum[-1] if n > 0 else torch.zeros((), dtype=torch.int64, device=dev)

    with torch.profiler.record_function("binning.sort"):
        order = torch.argsort(pre.depth, stable=True)
        rank = torch.empty_like(order)
        rank[order] = torch.arange(n, device=dev)
        rect_w = torch.clamp_min(pre.rect_max[:, 0] - pre.rect_min[:, 0], 1).to(torch.int32)
        packed = intervals[1].to(torch.int32).contiguous() if use_intervals else None

        keys, gid = _expand_kernel.expand_entries(
            counts, offsets, pre.rect_min.to(torch.int32).contiguous(), rect_w.contiguous(),
            rank, grid_x, max_dup, packed=packed)
        sorted_keys, perm = torch.sort(keys, stable=True)
    bounds = torch.arange(num_tiles + 1, dtype=torch.int64, device=dev) << 32
    edges = torch.searchsorted(sorted_keys, bounds)
    seg_bounds = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev), csum])
    seg_bounds.clamp_max_(max_dup)
    gauss_id, slot_pos = _segment_sum_kernel.permute_entries(gid, perm, total)
    return BinningOut(
        gauss_id=gauss_id,
        tile_start=edges[:-1],
        tile_end=edges[1:],
        num_entries=total,
        overflow=torch.clamp_min(total - max_dup, 0),
        seg_bounds=seg_bounds,
        slot_pos=slot_pos,
    )
