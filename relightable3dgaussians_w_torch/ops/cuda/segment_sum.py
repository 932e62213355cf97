"""Wrapper of the segment-sum kernel (`csrc/segment_sum.cu`).

Replaces the JAX package's Pallas `ops/pallas/segment_sum.py` `_kernel`; the
plain version is `ops/segment_sum.py` `segment_sum_rows_plain`. The kernel sums
a segment layout (`segment_sum_ordered`): the rasterizer's gather passes the
binning's own layout, and `segment_sum_rows` builds one from arbitrary ids.
`permute_entries` builds the binning's side of that layout after its sort
(plain version: `ops/binning.py` `permute_entries_plain`).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import build

launches = 0          # segment-sum launches since the last reset (set to 0 to reset)
permute_launches = 0  # permute_entries launches since the last reset

_P = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_int64


@functools.lru_cache(maxsize=None)
def _lib():
    return bind(build.load("segment_sum"))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a loaded build of `csrc/segment_sum.cu`."""
    lib.r3dgw_error_string.argtypes = [_I]
    lib.r3dgw_error_string.restype = ctypes.c_char_p
    lib.r3dgw_segment_sum_ordered.argtypes = [_P, _I, _P, _P, _I64, _P, _P]
    lib.r3dgw_segment_sum_ordered.restype = ctypes.c_int
    lib.r3dgw_permute_entries.argtypes = [_P, _P, _P, _I64, _P, _P, _P]
    lib.r3dgw_permute_entries.restype = ctypes.c_int
    return lib


def permute_entries(gid: torch.Tensor, perm: torch.Tensor, num_entries: torch.Tensor):
    """(gid[perm], the inverse of perm as int32) for the binning: the sorted
    entries' Gaussian ids and each pre-sort slot's sorted position.

    Args:
        gid: [D] int32 the expansion's ids; perm: [D] int64 the stable sort
            permutation of the expansion's keys; num_entries: [] int64 entries
            before the budget clamp. The slots past the real entries hold
            INT64_MAX keys, so the sort leaves them in place.
    Returns:
        gauss_id [D] int32, slot_pos [D] int32.
    """
    if not gid.is_cuda:
        from ..binning import permute_entries_plain

        return permute_entries_plain(gid, perm)
    global permute_launches
    dev = gid.device
    D = gid.shape[0]
    for name, t, dtype, shape in (("gid", gid, torch.int32, (D,)), ("perm", perm, torch.int64, (D,)),
                                  ("num_entries", num_entries, torch.int64, ())):
        if t.dtype != dtype or tuple(t.shape) != shape or t.device != dev \
                or not t.is_contiguous():
            raise ValueError(f"permute_entries: {name} must be a contiguous {dtype} "
                             f"{list(shape)} tensor on {dev}")
    gauss_id = torch.empty((D,), dtype=torch.int32, device=dev)
    slot_pos = torch.empty((D,), dtype=torch.int32, device=dev)
    if D == 0:
        return gauss_id, slot_pos
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.r3dgw_permute_entries(perm.data_ptr(), gid.data_ptr(), num_entries.data_ptr(),
                                        D, gauss_id.data_ptr(), slot_pos.data_ptr(), stream)
    build.check(lib, err, "permute_entries launch")
    permute_launches += 1
    return gauss_id, slot_pos


def segment_sum_ordered(rows: torch.Tensor, bounds: torch.Tensor,
                        order: torch.Tensor) -> torch.Tensor:
    """out[s] = sum of rows[order[p]] over p in bounds[s] .. bounds[s + 1], in
    ascending p (deterministic).

    Args:
        rows: [D, F] float32, contiguous.
        bounds: [n + 1] int64, non-decreasing.
        order: [P] int32 with P >= bounds[n]: the row of each position, each
            row at most once (the binning's `slot_pos`, or the stable sort
            permutation of ids).
    Returns:
        [n, F] float32.
    """
    if not rows.is_cuda:
        from ..segment_sum import layout_ids, segment_sum_rows_plain

        n = bounds.shape[0] - 1
        return segment_sum_rows_plain(rows, layout_ids(bounds, order, rows.shape[0]), n)
    global launches
    dev = rows.device
    if rows.dtype != torch.float32 or rows.ndim != 2 or not rows.is_contiguous():
        raise ValueError("segment_sum_ordered: rows must be a contiguous float32 [D, F] tensor")
    if bounds.dtype != torch.int64 or bounds.ndim != 1 or bounds.shape[0] < 1 \
            or bounds.device != dev or not bounds.is_contiguous():
        raise ValueError(f"segment_sum_ordered: bounds must be a contiguous int64 [n + 1] "
                         f"tensor on {dev}")
    if order.dtype != torch.int32 or order.ndim != 1 or order.device != dev \
            or not order.is_contiguous():
        raise ValueError(f"segment_sum_ordered: order must be a contiguous int32 [P] tensor "
                         f"on {dev}")
    F = rows.shape[1]
    n = bounds.shape[0] - 1
    if F < 1:
        raise ValueError(f"segment_sum_ordered: need F >= 1, got {F}")
    out = torch.empty((n, F), dtype=torch.float32, device=dev)
    if n == 0:
        return out
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.r3dgw_segment_sum_ordered(rows.data_ptr(), F, order.data_ptr(),
                                            bounds.data_ptr(), n, out.data_ptr(), stream)
    build.check(lib, err, "segment_sum_ordered launch")
    launches += 1
    return out


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
    from ..segment_sum import ids_layout

    D = rows.shape[0] if rows.ndim == 2 else -1
    if ids.dtype not in (torch.int32, torch.int64) or tuple(ids.shape) != (D,) \
            or ids.device != rows.device:
        raise ValueError(f"segment_sum_rows: ids must be int32 or int64 [{D}] on {rows.device}")
    if num_segments < 0:
        raise ValueError(f"segment_sum_rows: need num_segments >= 0, got {num_segments}")
    return segment_sum_ordered(rows, *ids_layout(ids, num_segments))
