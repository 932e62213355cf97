"""The entry gather and its transpose, the per-Gaussian segment sum.

Port of the JAX package's `ops/pallas/segment_sum.py` (`segment_sum_rows_jnp`,
`gather_rows_t`). The rasterizer gathers each Gaussian's feature row into every
(tile, Gaussian) entry slot; the gradient of that gather sums the entry rows
back into Gaussian rows. On the card the sum is the hand-written kernel of
`ops/cuda/segment_sum.py` (no atomics, so two runs give the same bits);
`segment_sum_rows_plain` below is its plain version, built on `index_add_`.

The kernel sums a segment layout: bounds [n + 1] (segment s owns the positions
bounds[s] .. bounds[s + 1]) and order (the row at each position). The gather
takes the binning's layout (`BinningOut.seg_bounds`, `.slot_pos`: each
Gaussian's run of pre-sort slots and their sorted positions), so its backward
needs no sort; `ids_layout` builds the same layout from arbitrary ids with one
stable sort, for the general `segment_sum_rows(rows, ids, n)`.

Rows are [D, F] row-major here (the JAX package keeps them transposed, [F_pad,
D], with F padded to a multiple of 8 for the TPU).

The entry budget has more slots than entries, and the slots past the last real
entry gather Gaussian 0. Their gradient rows are zero; they lie in no segment
of the binning's layout, and `entry_ids` gives them the id `num_segments`,
which the sum drops (as `jax.ops.segment_sum` drops out-of-range ids).
"""

from __future__ import annotations

import torch

from .cuda import segment_sum as _segment_sum_kernel


def segment_sum_rows_plain(rows: torch.Tensor, ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """out[i] = sum of rows[e] over the e with ids[e] == i.

    Args:
        rows: [D, F] float32; ids: [D] integer in [0, num_segments]; rows with
            id num_segments are dropped.
    Returns:
        [num_segments, F] float32.
    """
    out = torch.zeros((num_segments + 1, rows.shape[1]), dtype=rows.dtype, device=rows.device)
    return out.index_add_(0, ids.long(), rows)[:num_segments]


def entry_ids(gid: torch.Tensor, num_valid: torch.Tensor, num_segments: int) -> torch.Tensor:
    """The segment id of every slot: gid for the first num_valid slots, the
    dropped id num_segments past them (module docstring)."""
    slot = torch.arange(gid.shape[0], device=gid.device)
    return torch.where(slot < num_valid, gid, torch.full_like(gid, num_segments))


def ids_layout(ids: torch.Tensor, num_segments: int):
    """(bounds [n + 1] int64, order [D] int32) of ids in [0, num_segments]: one
    stable sort (ties keep entry order) and each segment's range of sorted
    positions by binary search; id num_segments falls past bounds[n]."""
    sorted_ids, perm = torch.sort(ids, stable=True)
    bounds = torch.searchsorted(
        sorted_ids, torch.arange(num_segments + 1, dtype=ids.dtype, device=ids.device))
    return bounds, perm.to(torch.int32)


def layout_ids(bounds: torch.Tensor, order: torch.Tensor, num_rows: int) -> torch.Tensor:
    """The segment id of each of num_rows rows in a layout (`ids_layout`'s
    inverse): s for the row at a position of segment s, n for rows at no
    position. No sort."""
    n = bounds.shape[0] - 1
    ids = torch.full((num_rows,), n, dtype=torch.int64, device=bounds.device)
    seg = torch.repeat_interleave(torch.arange(n, device=bounds.device), bounds.diff())
    ids[order[bounds[0]:bounds[0] + seg.shape[0]].long()] = seg
    return ids


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, feat_pack, gid, seg_bounds, seg_order):
        ctx.save_for_backward(seg_bounds, seg_order)
        return feat_pack[gid.long()]

    @staticmethod
    def backward(ctx, g_rows):
        seg_bounds, seg_order = ctx.saved_tensors
        with torch.profiler.record_function("gather_rows.backward"):
            d_pack = _segment_sum_kernel.segment_sum_ordered(g_rows.contiguous(), seg_bounds,
                                                             seg_order)
        return d_pack, None, None, None


def gather_rows(feat_pack: torch.Tensor, gid: torch.Tensor, seg_bounds: torch.Tensor,
                seg_order: torch.Tensor) -> torch.Tensor:
    """feat_pack[gid] ([N, F] -> [D, F]) whose gradient is the segment sum of
    the entry-row gradients by `gid` (the CUDA kernel on the card, the plain
    version on the CPU).

    seg_bounds [N + 1] int64, seg_order [>= seg_bounds[N]] int32: the layout of
    gid's real entries (module docstring): the binning's `seg_bounds` and
    `slot_pos`, or `ids_layout(entry_ids(gid, num_valid, N), N)`. Slots at no
    position carry no gradient."""
    return _GatherRows.apply(feat_pack, gid, seg_bounds, seg_order)
