"""Wrappers of the preprocess kernels (`csrc/preprocess.cu`).

They replace no TPU kernel: the JAX package leaves `ops/preprocess.py`
`preprocess` to XLA's fusion. `preprocess_forward` computes every field of a
`PreprocessOut` (kernel R) and `preprocess_backward` the gradients of the
positions, scales and rotations, or of a precomputed covariance (kernel R');
the plain versions, and the `torch.autograd.Function` that routes to them,
are in `ops/preprocess.py`. A CUDA tensor goes to the kernels or raises;
there is no fallback.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import build

launches = 0           # forward launches since the last reset (set to 0 to reset)
backward_launches = 0  # backward launches since the last reset

_P = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_int64
_F = ctypes.c_float


@functools.lru_cache(maxsize=None)
def _lib():
    lib = build.load("preprocess")
    lib.r3dgw_preprocess_forward.argtypes = [_P, _I64, _I, _I, _I, _F, _F, _F, _P, _P]
    lib.r3dgw_preprocess_forward.restype = ctypes.c_int
    lib.r3dgw_preprocess_backward.argtypes = [_P, _I64, _I, _I, _F, _P, _I64, _P, _I64, _P, _P,
                                              _P, _P]
    lib.r3dgw_preprocess_backward.restype = ctypes.c_int
    return lib


def _check(what, name, t, shape, dtype, dev):
    if t.dtype != dtype or tuple(t.shape) != shape or t.device != dev or not t.is_contiguous():
        raise ValueError(f"{what}: {name} must be a contiguous {dtype} {list(shape)} tensor "
                         f"on {dev}")


def _inputs(what, means3d, scales, quats, cov3d_precomp, opacities, active, camera):
    """Check the kernels' inputs; returns the C array of their pointers (0 for
    an absent one). camera: (viewmat [4, 4], projmat [4, 4], tan_fovx [],
    tan_fovy []), float32 on the rows' card."""
    dev, n = means3d.device, means3d.shape[0]
    if dev.type != "cuda":
        raise ValueError(f"{what}: runs on the card only (ops/preprocess.py routes CPU tensors "
                         "to the plain chain)")
    f32 = torch.float32
    _check(what, "means3d", means3d, (n, 3), f32, dev)
    if cov3d_precomp is None:
        if scales is None or quats is None:
            raise ValueError(f"{what}: scales and quats are needed without cov3d_precomp")
        _check(what, "scales", scales, (n, 3), f32, dev)
        _check(what, "quats", quats, (n, 4), f32, dev)
        scales_quats = (scales, quats)
    else:
        _check(what, "cov3d_precomp", cov3d_precomp, (n, 6), f32, dev)
        scales_quats = (None, None)
    if opacities is not None:
        _check(what, "opacities", opacities, (n,), f32, dev)
    if active is not None:
        _check(what, "active", active, (n,), torch.bool, dev)
    for name, t, shape in zip(("viewmat", "projmat", "tan_fovx", "tan_fovy"), camera,
                              ((4, 4), (4, 4), (), ())):
        _check(what, name, t, shape, f32, dev)
    tensors = (means3d, *scales_quats, cov3d_precomp, opacities, active, *camera)
    return (ctypes.c_void_p * 10)(*[0 if t is None else t.data_ptr() for t in tensors])


def preprocess_forward(means3d, scales, quats, cov3d_precomp, opacities, active, camera,
                       width: int, height: int, tile: int, scale_modifier: float,
                       skip_alpha: float):
    """Kernel R: (mean2d [n, 2], conic [n, 3], depth [n], radius [n],
    tiles_touched [n], rect_min [n, 2], rect_max [n, 2], cov3d [n, 6]), the
    fields of `preprocess.PreprocessOut` in order, bitwise the plain chain's.
    With cov3d_precomp the covariance returned is that tensor.

    Args:
        means3d [n, 3]; scales [n, 3] and quats [n, 4] (None with
            cov3d_precomp [n, 6]); opacities [n] or None (the untightened
            rects); active [n] bool or None; camera (viewmat, projmat,
            tan_fovx, tan_fovy): float32, contiguous, on one card.
    """
    global launches
    ptrs = _inputs("preprocess_forward", means3d, scales, quats, cov3d_precomp, opacities,
                   active, camera)
    dev, n = means3d.device, means3d.shape[0]
    f32, i32 = dict(dtype=torch.float32, device=dev), dict(dtype=torch.int32, device=dev)
    out = [torch.empty((n, 2), **f32), torch.empty((n, 3), **f32), torch.empty((n,), **f32),
           torch.empty((n,), **i32), torch.empty((n,), **i32), torch.empty((n, 2), **i32),
           torch.empty((n, 2), **i32),
           torch.empty((n, 6), **f32) if cov3d_precomp is None else cov3d_precomp]
    if n == 0:
        return tuple(out)
    order = (0, 1, 2, 7, 3, 4, 5, 6)   # the C interface's: the covariance fourth
    out_ptrs = (ctypes.c_void_p * 8)(*[0 if (k == 7 and cov3d_precomp is not None)
                                       else out[k].data_ptr() for k in order])
    lib = _lib()
    with torch.cuda.device(dev):
        err = lib.r3dgw_preprocess_forward(
            ptrs, n, int(width), int(height), int(tile), scale_modifier, 1.0 / skip_alpha,
            skip_alpha, out_ptrs, torch.cuda.current_stream(dev).cuda_stream)
    build.check(lib, err, "preprocess_forward launch")
    launches += 1
    return tuple(out)


def _rows_in_place(what, name, t, n, width, dev):
    """A cotangent the kernel reads in place: [n, width] float32 with its last
    stride 1 and rows apart (a column slice of a wider tensor passes); the
    row stride in floats. Anything else is copied first."""
    if t.dtype != torch.float32 or tuple(t.shape) != (n, width) or t.device != dev:
        raise ValueError(f"{what}: {name} must be a float32 [{n}, {width}] tensor on {dev}")
    if t.stride(-1) != 1 or (n > 1 and t.stride(0) < width):
        t = t.contiguous()
    return t, t.stride(0)


def preprocess_backward(means3d, scales, quats, cov3d_precomp, camera, width: int, height: int,
                        scale_modifier: float, g_mean2d, g_conic, g_depth=None, g_cov3d=None):
    """Kernel R': the gradients (d_means3d [n, 3], d_scales [n, 3], d_quats
    [n, 4], d_cov3d_precomp [n, 6]) of `preprocess_forward`'s inputs from the
    cotangents of mean2d [n, 2], conic [n, 3], depth [n] (or None) and cov3d
    [n, 6] (or None); d_scales and d_quats are None with cov3d_precomp,
    d_cov3d_precomp None without. One thread a row, no atomics: two runs give
    the same bits."""
    global backward_launches
    what = "preprocess_backward"
    ptrs = _inputs(what, means3d, scales, quats, cov3d_precomp, None, None, camera)
    dev, n = means3d.device, means3d.shape[0]
    g_mean2d, stride_m = _rows_in_place(what, "g_mean2d", g_mean2d, n, 2, dev)
    g_conic, stride_c = _rows_in_place(what, "g_conic", g_conic, n, 3, dev)
    if g_depth is not None:
        if g_depth.dtype != torch.float32 or tuple(g_depth.shape) != (n,) \
                or g_depth.device != dev:
            raise ValueError(f"{what}: g_depth must be a float32 [{n}] tensor on {dev}")
        g_depth = g_depth.contiguous()
    if g_cov3d is not None:
        if g_cov3d.dtype != torch.float32 or tuple(g_cov3d.shape) != (n, 6) \
                or g_cov3d.device != dev:
            raise ValueError(f"{what}: g_cov3d must be a float32 [{n}, 6] tensor on {dev}")
        g_cov3d = g_cov3d.contiguous()
    f32 = dict(dtype=torch.float32, device=dev)
    d_means = torch.empty((n, 3), **f32)
    if cov3d_precomp is None:
        grads = (d_means, torch.empty((n, 3), **f32), torch.empty((n, 4), **f32), None)
    else:
        grads = (d_means, None, None, torch.empty((n, 6), **f32))
    if n == 0:
        return grads
    lib = _lib()
    with torch.cuda.device(dev):
        err = lib.r3dgw_preprocess_backward(
            ptrs, n, int(width), int(height), scale_modifier, g_mean2d.data_ptr(), stride_m,
            g_conic.data_ptr(), stride_c, None if g_depth is None else g_depth.data_ptr(),
            None if g_cov3d is None else g_cov3d.data_ptr(),
            (ctypes.c_void_p * 4)(*[0 if g is None else g.data_ptr() for g in grads]),
            torch.cuda.current_stream(dev).cuda_stream)
    build.check(lib, err, "preprocess_backward launch")
    backward_launches += 1
    return grads
