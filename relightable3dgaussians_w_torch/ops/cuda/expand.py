"""Wrapper of the entry-expansion kernels (`csrc/expand.cu`).

Replaces the JAX package's Pallas `ops/pallas/expand.py` `_expand_kernel` in both
branches: the rect walk (`launches` counts it) and the row-interval walk
(`interval_launches`). The plain version is `ops/binning.py`
`expand_entries_plain`.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import build

launches = 0           # rect-walk launches since the last reset (set to 0 to reset)
interval_launches = 0  # row-interval-walk launches since the last reset

_P = ctypes.c_void_p
_I64 = ctypes.c_int64


@functools.lru_cache(maxsize=None)
def _lib():
    return bind(build.load("expand"))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a loaded build of `csrc/expand.cu`."""
    lib.r3dgw_error_string.argtypes = [ctypes.c_int]
    lib.r3dgw_error_string.restype = ctypes.c_char_p
    lib.r3dgw_expand_entries.argtypes = [_P, _P, _P, _P, _P, _I64, _I64, _I64, _P, _P, _P]
    lib.r3dgw_expand_entries.restype = ctypes.c_int
    lib.r3dgw_expand_entries_intervals.argtypes = [_P, _P, _P, _P, _P, _P, _I64, _I64, _I64,
                                                   _P, _P, _P]
    lib.r3dgw_expand_entries_intervals.restype = ctypes.c_int
    return lib


def _check_input(name, t, dtype, shape, dev, what="expand_entries"):
    if t.device != dev:
        raise ValueError(f"{what}: {name} is on {t.device}, expected {dev}")
    if t.dtype != dtype:
        raise TypeError(f"{what}: {name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{what}: {name} must have shape {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: {name} must be contiguous")


def expand_entries(counts: torch.Tensor, offsets: torch.Tensor, rect_min: torch.Tensor,
                   rect_w: torch.Tensor, rank: torch.Tensor, grid_x: int, max_dup: int,
                   packed: torch.Tensor | None = None):
    """Per entry slot: key (tile << 32) | rank and the Gaussian id.

    Args:
        counts: [N] int32; offsets: [N] int64 (exclusive cumsum of counts);
        rect_min: [N, 2] int32; rect_w: [N] int32 (>= 1); rank: [N] int64.
        packed: optional [8, N] int32 per-row intervals (txl_rel + 128 * w_j);
            then counts are the interval counts and the interval walk runs.
    Returns:
        keys [max_dup] int64 (INT64_MAX where unwritten), gid [max_dup] int32
        (0 where unwritten).
    """
    if not counts.is_cuda:
        from ..binning import expand_entries_plain

        return expand_entries_plain(counts, offsets, rect_min, rect_w, rank, grid_x, max_dup,
                                    packed)
    global launches, interval_launches
    dev = counts.device
    n = counts.shape[0]
    _check_input("counts", counts, torch.int32, (n,), dev)
    _check_input("offsets", offsets, torch.int64, (n,), dev)
    _check_input("rect_min", rect_min, torch.int32, (n, 2), dev)
    _check_input("rect_w", rect_w, torch.int32, (n,), dev)
    _check_input("rank", rank, torch.int64, (n,), dev)
    if packed is not None:
        _check_input("packed", packed, torch.int32, (8, n), dev)
    keys = torch.empty((max_dup,), dtype=torch.int64, device=dev)
    gid = torch.empty((max_dup,), dtype=torch.int32, device=dev)
    if max(n, max_dup) == 0:
        return keys, gid
    lib = _lib()
    ptrs = (counts.data_ptr(), offsets.data_ptr(), rect_min.data_ptr(), rect_w.data_ptr(),
            rank.data_ptr())
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if packed is None:
            err = lib.r3dgw_expand_entries(*ptrs, n, grid_x, max_dup, keys.data_ptr(),
                                           gid.data_ptr(), stream)
        else:
            err = lib.r3dgw_expand_entries_intervals(*ptrs, packed.data_ptr(), n, grid_x,
                                                     max_dup, keys.data_ptr(), gid.data_ptr(),
                                                     stream)
    if packed is None:
        build.check(lib, err, "expand_entries launch")
        launches += 1
    else:
        build.check(lib, err, "expand_entries (intervals) launch")
        interval_launches += 1
    return keys, gid
