"""Wrappers of the tile-compositing kernels (`csrc/tile_composite.cu`).

`composite_forward` replaces the JAX package's Pallas
`ops/pallas/tile_composite.py` `_fwd_kernel`, `composite_forward_packed` (kernel
B') that kernel's `packed_rgb` branch and `composite_backward` its
`_bwd_kernel`; the plain versions are `ops/composite.py` `composite_forward`,
`composite_forward_packed` and `composite_backward`. `composite_tiles` is the
differentiable compositor (the JAX package's `wrapper.composite_tiles_pallas` /
`composite.composite_tiles`): forward and backward are the two kernels on the
card and the plain versions on the CPU. Packed rows are forward-only:
`composite_forward_packed` refuses a feature tensor that requires grad, as the
JAX package's VJP refuses the mode.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import build

launches = 0           # forward kernel launches since the last reset (set to 0 to reset)
packed_launches = 0    # packed forward (B') launches since the last reset
backward_launches = 0  # backward kernel launches since the last reset

TILE = 16       # the kernel runs one 256-thread block per 16x16 tile
MAX_FORWARD_CHANNELS = 64    # the fused 17-angle relighting sweep composites 51
MAX_BACKWARD_CHANNELS = 32   # no path differentiates more than 21

_P = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_int64


@functools.lru_cache(maxsize=None)
def _lib():
    return bind(build.load("tile_composite"))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a loaded build of `csrc/tile_composite.cu`."""
    lib.r3dgw_error_string.argtypes = [_I]
    lib.r3dgw_error_string.restype = ctypes.c_char_p
    lib.r3dgw_composite_forward.argtypes = [_P, _I64, _I, _P, _P, _P, _I, _I, _P, _P, _P]
    lib.r3dgw_composite_forward.restype = ctypes.c_int
    lib.r3dgw_composite_forward_packed.argtypes = [_P, _I64, _P, _P, _P, _I, _I, _P, _P, _P]
    lib.r3dgw_composite_forward_packed.restype = ctypes.c_int
    lib.r3dgw_composite_backward.argtypes = [_P, _I64, _I, _P, _P, _P, _P, _P, _P, _I, _I,
                                             _P, _P]
    lib.r3dgw_composite_backward.restype = ctypes.c_int
    return lib


def _check(what, name, t, dtype, shape, dev):
    if t.dtype != dtype or tuple(t.shape) != shape or t.device != dev or not t.is_contiguous():
        raise ValueError(f"{what}: {name} must be a contiguous {dtype} {list(shape)} tensor on {dev}")


def _check_ranges(what, tile_start, tile_end, T, dev):
    for name, t in (("tile_start", tile_start), ("tile_end", tile_end)):
        _check(what, name, t, torch.int64, (T,), dev)


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
    if not 1 <= C <= MAX_FORWARD_CHANNELS:
        raise ValueError(f"composite_forward: 1..{MAX_FORWARD_CHANNELS} channels supported, "
                         f"got {C}")
    if bg.dtype != torch.float32 or tuple(bg.shape) != (C,) or bg.device != dev:
        raise ValueError(f"composite_forward: bg must be float32 [{C}] on {dev}")
    bg = bg.contiguous()
    _check_ranges("composite_forward", tile_start, tile_end, T, dev)
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


def composite_forward_packed(feat: torch.Tensor, tile_start: torch.Tensor,
                             tile_end: torch.Tensor, bg: torch.Tensor, grid_x: int, grid_y: int,
                             tile: int = 16):
    """Composite packed serving rows (kernel B'): forward only.

    Args:
        feat: [D, 8] float32 entry rows: mx, my, conic a, b, c, opacity, R and B
            packed by `ops/composite.pack_rb`, G.
        tile_start, tile_end: [grid_x * grid_y] int64 entry range of each tile.
        bg: [3] float32 background.
    Returns:
        (tiles_rgb [T, P, 3] with T_final * bg added, tiles_tfin [T, P]).
    """
    if feat.requires_grad and torch.is_grad_enabled():
        raise ValueError("packed rows are a forward-only serving format: no gradient "
                         "flows through them (render with packed_rgb=False to train)")
    if not feat.is_cuda:
        from ..composite import composite_forward_packed as plain

        return plain(feat, tile_start, tile_end, bg, grid_x, grid_y, tile)
    global packed_launches
    dev = feat.device
    T = grid_x * grid_y
    what = "composite_forward_packed"
    if tile != TILE:
        raise ValueError(f"{what} kernel needs tile={TILE}, got {tile}")
    _check(what, "feat", feat, torch.float32, (feat.shape[0], 8), dev)
    _check(what, "bg", bg, torch.float32, (3,), dev)
    _check_ranges(what, tile_start, tile_end, T, dev)
    out_rgb = torch.empty((T, TILE * TILE, 3), dtype=torch.float32, device=dev)
    out_tfin = torch.empty((T, TILE * TILE), dtype=torch.float32, device=dev)
    if T == 0:
        return out_rgb, out_tfin
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.r3dgw_composite_forward_packed(
            feat.data_ptr(), feat.shape[0], tile_start.data_ptr(), tile_end.data_ptr(),
            bg.data_ptr(), grid_x, T, out_rgb.data_ptr(), out_tfin.data_ptr(), stream)
    build.check(lib, err, f"{what} launch")
    packed_launches += 1
    return out_rgb, out_tfin


def composite_backward(feat: torch.Tensor, tile_start: torch.Tensor, tile_end: torch.Tensor,
                       bg: torch.Tensor, tiles_rgb: torch.Tensor, tiles_tfin: torch.Tensor,
                       g_tiles: torch.Tensor, g_tfin: torch.Tensor, grid_x: int, grid_y: int,
                       tile: int = 16):
    """Analytic backward of `composite_forward`.

    Args:
        feat, tile_start, tile_end, bg: the forward's inputs.
        tiles_rgb [T, P, C], tiles_tfin [T, P]: the forward's outputs.
        g_tiles [T, P, C], g_tfin [T, P]: their cotangents.
    Returns:
        (d_feat [D, 6 + C], d_bg [C]).
    """
    if not feat.is_cuda:
        from ..composite import composite_backward as plain

        return plain(feat, tile_start, tile_end, bg, grid_x, grid_y, g_tiles, g_tfin, tile)
    global backward_launches
    dev = feat.device
    T = grid_x * grid_y
    if tile != TILE:
        raise ValueError(f"composite_backward kernel needs tile={TILE}, got {tile}")
    if feat.dtype != torch.float32 or feat.ndim != 2 or not feat.is_contiguous():
        raise ValueError("composite_backward: feat must be a contiguous float32 [D, 6 + C] tensor")
    C = feat.shape[1] - 6
    if not 1 <= C <= MAX_BACKWARD_CHANNELS:
        raise ValueError(f"composite_backward: 1..{MAX_BACKWARD_CHANNELS} channels supported, "
                         f"got {C}")
    P = TILE * TILE
    what = "composite_backward"
    _check(what, "bg", bg, torch.float32, (C,), dev)
    _check_ranges(what, tile_start, tile_end, T, dev)
    for name, t in (("tiles_rgb", tiles_rgb), ("g_tiles", g_tiles)):
        _check(what, name, t, torch.float32, (T, P, C), dev)
    for name, t in (("tiles_tfin", tiles_tfin), ("g_tfin", g_tfin)):
        _check(what, name, t, torch.float32, (T, P), dev)
    # Per-pixel scalars, as the JAX package computes them outside its kernel:
    # total = (out - T_final * bg) . gbar and B = bg . gbar + g_Tfinal.
    total = ((tiles_rgb - tiles_tfin[..., None] * bg) * g_tiles).sum(-1)
    bterm = (g_tiles * bg).sum(-1) + g_tfin
    d_bg = (tiles_tfin[..., None] * g_tiles).sum((0, 1))
    d_feat = torch.zeros_like(feat)
    if T == 0:
        return d_feat, d_bg
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.r3dgw_composite_backward(
            feat.data_ptr(), feat.shape[0], C, tile_start.data_ptr(), tile_end.data_ptr(),
            g_tiles.data_ptr(), total.data_ptr(), bterm.data_ptr(), tiles_tfin.data_ptr(),
            grid_x, T, d_feat.data_ptr(), stream)
    build.check(lib, err, "composite_backward launch")
    backward_launches += 1
    return d_feat, d_bg


class _CompositeTiles(torch.autograd.Function):
    @staticmethod
    def forward(ctx, feat, tile_start, tile_end, bg, grid_x, grid_y, tile):
        tiles_rgb, tiles_tfin = composite_forward(feat, tile_start, tile_end, bg,
                                                  grid_x, grid_y, tile)
        ctx.save_for_backward(feat, tile_start, tile_end, bg, tiles_rgb, tiles_tfin)
        ctx.grid = (grid_x, grid_y, tile)
        return tiles_rgb, tiles_tfin

    @staticmethod
    def backward(ctx, g_tiles, g_tfin):
        feat, tile_start, tile_end, bg, tiles_rgb, tiles_tfin = ctx.saved_tensors
        with torch.profiler.record_function("composite_tiles.backward"):
            d_feat, d_bg = composite_backward(feat, tile_start, tile_end, bg, tiles_rgb,
                                              tiles_tfin, g_tiles.contiguous(),
                                              g_tfin.contiguous(), *ctx.grid)
        return d_feat, None, None, d_bg, None, None, None


def composite_tiles(feat: torch.Tensor, tile_start: torch.Tensor, tile_end: torch.Tensor,
                    bg: torch.Tensor, grid_x: int, grid_y: int, tile: int = 16):
    """Differentiable `composite_forward`: (tiles_rgb, tiles_tfin), with gradients
    for feat and bg from `composite_backward`."""
    return _CompositeTiles.apply(feat, tile_start, tile_end, bg, grid_x, grid_y, tile)
