"""Wrapper of the segment-sum kernel (`csrc/segment_sum.cu`).

Replaces the JAX package's Pallas `ops/pallas/segment_sum.py` `_kernel`; the
plain version is `ops/segment_sum.py` `segment_sum_rows_plain`.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import build

launches = 0  # kernel launches since the last reset (set to 0 to reset)

_P = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_int64


@functools.lru_cache(maxsize=None)
def _lib():
    lib = build.load("segment_sum")
    lib.r3dgw_segment_sum.argtypes = [_P, _I, _P, _P, _I64, _P, _P]
    lib.r3dgw_segment_sum.restype = ctypes.c_int
    return lib


def segment_sum_rows(rows: torch.Tensor, ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """out[i] = sum of rows[e] over the e with ids[e] == i, each sum in ascending
    entry order (deterministic).

    Args:
        rows: [D, F] float32, contiguous; ids: [D] int32 or int64 in
            [0, num_segments]; rows with id num_segments are dropped.
    Returns:
        [num_segments, F] float32.
    """
    if not rows.is_cuda:
        from ..segment_sum import segment_sum_rows_plain

        return segment_sum_rows_plain(rows, ids, num_segments)
    global launches
    dev = rows.device
    if rows.dtype != torch.float32 or rows.ndim != 2 or not rows.is_contiguous():
        raise ValueError("segment_sum_rows: rows must be a contiguous float32 [D, F] tensor")
    D, F = rows.shape
    if ids.dtype not in (torch.int32, torch.int64) or tuple(ids.shape) != (D,) \
            or ids.device != dev:
        raise ValueError(f"segment_sum_rows: ids must be int32 or int64 [{D}] on {dev}")
    if F < 1 or num_segments < 0:
        raise ValueError(f"segment_sum_rows: need F >= 1 and num_segments >= 0, got {F}, "
                         f"{num_segments}")
    out = torch.empty((num_segments, F), dtype=torch.float32, device=dev)
    if num_segments == 0:
        return out
    # One stable sort of the ids (ties keep entry order) and each segment's
    # range of sorted positions by binary search.
    sorted_ids, perm = torch.sort(ids, stable=True)
    bounds = torch.searchsorted(
        sorted_ids, torch.arange(num_segments + 1, dtype=ids.dtype, device=dev))
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.r3dgw_segment_sum(rows.data_ptr(), F, perm.data_ptr(), bounds.data_ptr(),
                                    num_segments, out.data_ptr(), stream)
    build.check(lib, err, "segment_sum_rows launch")
    launches += 1
    return out
