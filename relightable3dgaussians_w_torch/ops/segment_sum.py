"""The entry gather and its transpose, the per-Gaussian segment sum.

Port of the JAX package's `ops/pallas/segment_sum.py` (`segment_sum_rows_jnp`,
`gather_rows_t`). The rasterizer gathers each Gaussian's feature row into every
(tile, Gaussian) entry slot; the gradient of that gather sums the entry rows
back into Gaussian rows. On the card the sum is the hand-written kernel of
`ops/cuda/segment_sum.py` (sorted ids, one warp per Gaussian, no atomics, so
two runs give the same bits); `segment_sum_rows_plain` below is its plain
version, built on `index_add_`.

Rows are [D, F] row-major here (the JAX package keeps them transposed, [F_pad,
D], with F padded to a multiple of 8 for the TPU).

The entry budget has more slots than entries, and the slots past the last real
entry gather Gaussian 0. Their gradient rows are zero, but summed under id 0
they would make one segment of hundreds of thousands of rows, which one warp
walks alone; so the backward gives them the id `num_segments`, which the sum
drops (as `jax.ops.segment_sum` drops out-of-range ids).
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


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, feat_pack, gid, num_valid):
        ctx.save_for_backward(gid, num_valid)
        ctx.num_segments = feat_pack.shape[0]
        return feat_pack[gid.long()]

    @staticmethod
    def backward(ctx, g_rows):
        gid, num_valid = ctx.saved_tensors
        with torch.profiler.record_function("gather_rows.backward"):
            ids = entry_ids(gid, num_valid, ctx.num_segments)
            d_pack = _segment_sum_kernel.segment_sum_rows(g_rows.contiguous(), ids,
                                                          ctx.num_segments)
        return d_pack, None, None


def gather_rows(feat_pack: torch.Tensor, gid: torch.Tensor,
                num_valid: torch.Tensor) -> torch.Tensor:
    """feat_pack[gid] ([N, F] -> [D, F]) whose gradient is the segment sum of
    the entry-row gradients by `gid` (the CUDA kernel on the card, the plain
    version on the CPU).

    num_valid: [] count of real entries (the binning's num_entries); the slots
    past it carry no gradient (their rows are dropped from the sum)."""
    return _GatherRows.apply(feat_pack, gid, num_valid)
