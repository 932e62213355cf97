"""Wrapper of the tile-compositing forward kernel (`csrc/tile_composite.cu`).

Replaces the JAX package's Pallas `ops/pallas/tile_composite.py` `_fwd_kernel`;
the plain version is `ops/composite.py` `composite_forward`.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import build

launches = 0  # kernel launches since the last reset (set to 0 to reset)

TILE = 16       # the kernel runs one 256-thread block per 16x16 tile
MAX_CHANNELS = 32

_P = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_int64


@functools.lru_cache(maxsize=None)
def _lib():
    lib = build.load("tile_composite")
    lib.r3dgw_composite_forward.argtypes = [_P, _I64, _I, _P, _P, _P, _I, _I, _P, _P, _P]
    lib.r3dgw_composite_forward.restype = ctypes.c_int
    return lib


def composite_forward(feat: torch.Tensor, tile_start: torch.Tensor, tile_end: torch.Tensor,
                      bg: torch.Tensor, grid_x: int, grid_y: int, tile: int = 16):
    """Composite all tiles front to back.

    Args:
        feat: [D, 6 + C] float32 entry rows in sorted order: mx, my, conic a, b,
            c, opacity, C colors.
        tile_start, tile_end: [grid_x * grid_y] int64 entry range of each tile.
        bg: [C] float32 background.
    Returns:
        (tiles_rgb [T, P, C] with T_final * bg added, tiles_tfin [T, P]).
    """
    if not feat.is_cuda:
        from ..composite import composite_forward as plain

        return plain(feat, tile_start, tile_end, bg, grid_x, grid_y, tile)
    global launches
    dev = feat.device
    T = grid_x * grid_y
    if tile != TILE:
        raise ValueError(f"composite_forward kernel needs tile={TILE}, got {tile}")
    if feat.dtype != torch.float32 or feat.ndim != 2 or not feat.is_contiguous():
        raise ValueError("composite_forward: feat must be a contiguous float32 [D, 6 + C] tensor")
    C = feat.shape[1] - 6
    if not 1 <= C <= MAX_CHANNELS:
        raise ValueError(f"composite_forward: 1..{MAX_CHANNELS} channels supported, got {C}")
    if bg.dtype != torch.float32 or tuple(bg.shape) != (C,) or bg.device != dev:
        raise ValueError(f"composite_forward: bg must be float32 [{C}] on {dev}")
    bg = bg.contiguous()
    for name, t in (("tile_start", tile_start), ("tile_end", tile_end)):
        if t.dtype != torch.int64 or tuple(t.shape) != (T,) or t.device != dev \
                or not t.is_contiguous():
            raise ValueError(f"composite_forward: {name} must be contiguous int64 [{T}] on {dev}")
    out_rgb = torch.empty((T, TILE * TILE, C), dtype=torch.float32, device=dev)
    out_tfin = torch.empty((T, TILE * TILE), dtype=torch.float32, device=dev)
    if T == 0:
        return out_rgb, out_tfin
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.r3dgw_composite_forward(
            feat.data_ptr(), feat.shape[0], C, tile_start.data_ptr(), tile_end.data_ptr(),
            bg.data_ptr(), grid_x, T, out_rgb.data_ptr(), out_tfin.data_ptr(), stream)
    build.check(lib, err, "composite_forward launch")
    launches += 1
    return out_rgb, out_tfin
