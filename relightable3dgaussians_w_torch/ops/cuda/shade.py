"""Wrappers of the per-Gaussian shading kernels (`csrc/shade.cu`).

They replace no TPU kernel: the JAX package leaves `renderer.compute_colors`
to XLA's fusion. `shade_forward` computes the feature channels of every row
(kernel S) and `shade_backward` their gradient (kernel S'); the plain versions,
and the `torch.autograd.Function` that routes to them, are in
`ops/shading.py`. A CUDA tensor goes to the kernels or raises; there is no
fallback.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import build

launches = 0           # forward kernel launches since the last reset (set to 0 to reset)
backward_launches = 0  # backward launches (kernel and its partial sums) since the last reset

ENV_DEGREES = range(2, 6)   # the irradiance reads SH coefficients 0..8
SKY_DEGREES = range(0, 6)
LAYOUTS = (3, 13, 21)

_P = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_int64


@functools.lru_cache(maxsize=None)
def _lib():
    return bind(build.load("shade"))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a loaded build of `csrc/shade.cu`."""
    lib.r3dgw_error_string.argtypes = [_I]
    lib.r3dgw_error_string.restype = ctypes.c_char_p
    lib.r3dgw_shade_backward_blocks.argtypes = [_I64]
    lib.r3dgw_shade_backward_blocks.restype = ctypes.c_int
    lib.r3dgw_shade_forward.argtypes = [_P, _I64, _I, _I, _I, _I, _I, _P, _P, _P]
    lib.r3dgw_shade_forward.restype = ctypes.c_int
    lib.r3dgw_shade_backward.argtypes = [_P, _I64, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P]
    lib.r3dgw_shade_backward.restype = ctypes.c_int
    return lib


def _inputs(what, rows, base, sky_sh, campos, view_row, lut, env_deg, sky_deg, channels):
    """Check the kernels' inputs; returns the C array of their pointers."""
    xyz = rows[0]
    dev, n = xyz.device, xyz.shape[0]
    if env_deg not in ENV_DEGREES or sky_deg not in SKY_DEGREES:
        raise ValueError(f"{what}: SH degrees envlight {list(ENV_DEGREES)} and sky "
                         f"{list(SKY_DEGREES)} are built, got {env_deg} and {sky_deg}")
    if channels not in LAYOUTS:
        raise ValueError(f"{what}: layouts {LAYOUTS} are built, got {channels} channels")
    ke, ks = (env_deg + 1) ** 2, (sky_deg + 1) ** 2
    want = [("xyz", (n, 3)), ("rotation", (n, 4)), ("scaling", (n, 3)), ("albedo", (n, 3)),
            ("roughness", (n, 1)), ("metalness", (n, 1)), ("is_sky", (n,)),
            ("envlight", (ke, 3)), ("sky_sh", (ks, 3)), ("campos", (3,)), ("view_row", (4,)),
            ("lut", (256, 256, 8))]
    tensors = list(rows) + [base, sky_sh, campos, view_row, lut]
    for (name, shape), t in zip(want, tensors, strict=True):
        if t is None and name == "view_row":
            continue
        dtype = torch.bool if name == "is_sky" else torch.float32
        if t.dtype != dtype or tuple(t.shape) != shape or t.device != dev \
                or not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be a contiguous {dtype} {list(shape)} "
                             f"tensor on {dev}")
    if dev.type != "cuda":
        raise ValueError(f"{what}: runs on the card only (ops/shading.py routes CPU tensors to "
                         "the plain chain)")
    return (ctypes.c_void_p * 12)(*[0 if t is None else t.data_ptr() for t in tensors])


def shade_forward(rows, base, sky_sh, campos, view_row, lut, env_deg: int, sky_deg: int,
                  channels: int, specular: bool, fix_sky: bool, normals: bool):
    """Kernel S: the feature channels [n, channels] of the raw rows (and the
    normals [n, 3], else None).

    Args:
        rows: (xyz [n, 3] merged, rotation [n, 4], scaling [n, 3], albedo
            [n, 3], roughness [n, 1], metalness [n, 1] raw leaves, is_sky [n]
            bool), all contiguous on one card.
        base: [(env_deg+1)**2, 3]; sky_sh: [(sky_deg+1)**2, 3]; campos: [3];
        view_row: the view matrix's third row [4] (fills the depth channel)
            or None; lut: the quad-packed FG LUT [256, 256, 8].
    """
    global launches
    n = rows[0].shape[0]
    ptrs = _inputs("shade_forward", rows, base, sky_sh, campos, view_row, lut, env_deg,
                   sky_deg, channels)
    dev = rows[0].device
    out = torch.empty((n, channels), dtype=torch.float32, device=dev)
    nrm = torch.empty((n, 3), dtype=torch.float32, device=dev) if normals else None
    if n == 0:
        return out, nrm
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.r3dgw_shade_forward(ptrs, n, env_deg, sky_deg, channels, int(specular),
                                      int(fix_sky), out.data_ptr(),
                                      None if nrm is None else nrm.data_ptr(), stream)
    build.check(lib, err, "shade_forward launch")
    launches += 1
    return out, nrm


def shade_backward(rows, base, sky_sh, campos, view_row, lut, env_deg: int, sky_deg: int,
                   specular: bool, fix_sky: bool, g_out, g_normals):
    """Kernel S': the gradients of `shade_forward`'s inputs from those of its
    outputs (g_out [n, channels]; g_normals [n, 3] or None).

    Returns:
        (d_xyz [n, 3], d_rotation [n, 4], d_albedo [n, 3], d_roughness [n, 1],
        d_metalness [n, 1], d_envlight [(env_deg+1)**2, 3], d_sky
        [(sky_deg+1)**2, 3]); the envlight's and the sky's summed over the
        rows in a fixed order (two runs give the same bits).
    """
    global backward_launches
    xyz = rows[0]
    dev, n = xyz.device, xyz.shape[0]
    channels = g_out.shape[-1] if g_out.ndim == 2 else -1
    ptrs = _inputs("shade_backward", rows, base, sky_sh, campos, view_row, lut, env_deg,
                   sky_deg, channels)
    if tuple(g_out.shape) != (n, channels) or g_out.dtype != torch.float32 \
            or g_out.device != dev or not g_out.is_contiguous():
        raise ValueError(f"shade_backward: g_out must be a contiguous float32 [{n}, C] tensor "
                         f"on {dev}")
    if g_normals is not None and (tuple(g_normals.shape) != (n, 3) or not g_normals.is_contiguous()
                                  or g_normals.dtype != torch.float32 or g_normals.device != dev):
        raise ValueError(f"shade_backward: g_normals must be a contiguous float32 [{n}, 3] "
                         f"tensor on {dev}")
    ke, ks = (env_deg + 1) ** 2, (sky_deg + 1) ** 2
    f32 = dict(dtype=torch.float32, device=dev)
    grads = [torch.empty((n, 3), **f32), torch.empty((n, 4), **f32), torch.empty((n, 3), **f32),
             torch.empty((n, 1), **f32), torch.empty((n, 1), **f32), torch.empty((ke, 3), **f32),
             torch.empty((ks, 3), **f32)]
    lib = _lib()
    partial = torch.empty((lib.r3dgw_shade_backward_blocks(n), (ke + ks) * 3), **f32)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.r3dgw_shade_backward(
            ptrs, n, env_deg, sky_deg, channels, int(specular), int(fix_sky), g_out.data_ptr(),
            None if g_normals is None else g_normals.data_ptr(),
            (ctypes.c_void_p * 7)(*[g.data_ptr() for g in grads]), partial.data_ptr(), stream)
    build.check(lib, err, "shade_backward launch")
    backward_launches += 1
    return tuple(grads)
