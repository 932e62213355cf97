"""Tile binning: entry expansion, one (tile, depth) sort, per-tile ranges.

Port of the JAX package's `ops/binning.py` `bin_gaussians`, itself the
reference's `duplicateWithKeys` + radix sort + `identifyTileRanges`. The flow is
expand -> one stable sort -> tile ranges:

* Gaussians are ranked by a stable depth argsort (ties by index, as the
  reference's stable radix sort over positive depths orders them);
* per-Gaussian entry offsets are the exclusive cumsum of `tiles_touched`;
* the expansion (`expand_entries`, a CUDA kernel on the card, the plain version
  below on the CPU) writes, per entry slot, the int64 key (tile << 32) | rank
  from the Gaussian's row-major tile-rect walk, and the Gaussian id;
* one stable sort of the keys gives every tile's entries in depth order, and
  the tile ranges come from a binary search of the sorted keys.

The entry budget `max_dup` is static, as in the JAX package: entries past it are
dropped and `overflow` says how many.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .cuda import expand as _expand_kernel
from .preprocess import PreprocessOut

KEY_INVALID = torch.iinfo(torch.int64).max  # key of every unwritten slot


class BinningOut(NamedTuple):
    gauss_id: torch.Tensor    # [max_dup] int32 source Gaussian per sorted entry
    tile_start: torch.Tensor  # [num_tiles] int64 first entry of each tile
    tile_end: torch.Tensor    # [num_tiles] int64 one-past-last entry of each tile
    num_entries: torch.Tensor # [] int64 entries before the budget clamp
    overflow: torch.Tensor    # [] int64 entries dropped by the budget (0 = exact)


def expand_entries_plain(counts: torch.Tensor, offsets: torch.Tensor,
                         rect_min: torch.Tensor, rect_w: torch.Tensor,
                         rank: torch.Tensor, grid_x: int, max_dup: int):
    """Plain version of the expansion kernel (`csrc/expand.cu`).

    Args:
        counts: [N] int32 entries per Gaussian (tiles_touched).
        offsets: [N] int64 exclusive cumsum of counts.
        rect_min: [N, 2] int32 first tile (tx, ty) of each rect.
        rect_w: [N] int32 rect width in tiles (>= 1).
        rank: [N] int64 depth rank.
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
    q = slot // w
    r = slot - q * w
    tile = (rect_min[g, 1].long() + q) * grid_x + rect_min[g, 0].long() + r
    keys[: g.shape[0]] = (tile << 32) | rank[g]
    gid[: g.shape[0]] = g.to(torch.int32)
    return keys, gid


def bin_gaussians(pre: PreprocessOut, grid_x: int, grid_y: int, max_dup: int) -> BinningOut:
    """The depth-sorted per-tile entry list within a static budget of `max_dup`."""
    n = pre.depth.shape[0]
    dev = pre.depth.device
    num_tiles = grid_x * grid_y

    counts = pre.tiles_touched.to(torch.int32).contiguous()
    csum = torch.cumsum(counts, dim=0, dtype=torch.int64)
    offsets = csum - counts
    total = csum[-1] if n > 0 else torch.zeros((), dtype=torch.int64, device=dev)

    order = torch.argsort(pre.depth, stable=True)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(n, device=dev)
    rect_w = torch.clamp_min(pre.rect_max[:, 0] - pre.rect_min[:, 0], 1).to(torch.int32)

    keys, gid = _expand_kernel.expand_entries(
        counts, offsets, pre.rect_min.to(torch.int32).contiguous(), rect_w.contiguous(),
        rank, grid_x, max_dup)
    sorted_keys, perm = torch.sort(keys, stable=True)
    bounds = torch.arange(num_tiles + 1, dtype=torch.int64, device=dev) << 32
    edges = torch.searchsorted(sorted_keys, bounds)
    return BinningOut(
        gauss_id=gid[perm],
        tile_start=edges[:-1],
        tile_end=edges[1:],
        num_entries=total,
        overflow=torch.clamp_min(total - max_dup, 0),
    )
