"""Wrapper of the row-interval kernel (`csrc/row_intervals.cu`).

Replaces no TPU kernel: it fuses the port's eager row-interval pass
(`ops/preprocess.py` `row_intervals_plain`, the JAX package's XLA
`row_intervals`) into one pass over the rows, the input half of the interval
expansion (`ops/cuda/expand.py`, kernel A-int). `launches` counts its launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import build
from .expand import _check_input

launches = 0  # launches since the last reset (set to 0 to reset)

_P = ctypes.c_void_p
H_CAP = 8     # packed rows (preprocess.H_CAP)


@functools.lru_cache(maxsize=None)
def _lib():
    lib = build.load("row_intervals")
    lib.r3dgw_row_intervals.argtypes = [_P, _P, _P, _P, _P, _P, ctypes.c_int64, ctypes.c_int,
                                        ctypes.c_float, _P, _P, _P]
    lib.r3dgw_row_intervals.restype = ctypes.c_int
    return lib


def row_intervals(pre, opacities: torch.Tensor, tile: int = 16,
                  skip_alpha: float = 1.0 / 255.0):
    """Counts [N] int32 and packed [8, N] int32 (txl_rel + 128 * w_j) of each
    Gaussian's row intervals, from a `preprocess.PreprocessOut` and the
    activated opacities ([N] or [N, 1]). For CPU tensors: the plain version
    (`preprocess.row_intervals_plain`) with its float32 rows converted to int32."""
    global launches
    if not pre.mean2d.is_cuda:
        from ..preprocess import row_intervals_plain

        counts, packed = row_intervals_plain(pre, opacities, tile, skip_alpha)
        return counts, packed.to(torch.int32)
    dev = pre.mean2d.device
    n = pre.mean2d.shape[0]
    op = opacities[:, 0] if opacities.ndim == 2 else opacities
    args = [t.detach().contiguous() for t in (pre.mean2d, pre.conic, op, pre.rect_min,
                                              pre.rect_max, pre.tiles_touched)]
    for name, t, dtype, shape in zip(
            ("mean2d", "conic", "opacity", "rect_min", "rect_max", "tiles_touched"), args,
            (torch.float32,) * 3 + (torch.int32,) * 3,
            ((n, 2), (n, 3), (n,), (n, 2), (n, 2), (n,))):
        _check_input(name, t, dtype, shape, dev, "row_intervals")
    counts = torch.empty((n,), dtype=torch.int32, device=dev)
    packed = torch.empty((H_CAP, n), dtype=torch.int32, device=dev)
    if n == 0:
        return counts, packed
    lib = _lib()
    with torch.cuda.device(dev):
        err = lib.r3dgw_row_intervals(
            *(t.data_ptr() for t in args), n, int(tile), ctypes.c_float(1.0 / skip_alpha),
            counts.data_ptr(), packed.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    build.check(lib, err, "row_intervals launch")
    launches += 1
    return counts, packed
