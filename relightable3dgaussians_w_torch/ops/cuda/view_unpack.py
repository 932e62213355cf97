"""Wrapper of the view-unpack kernel V (`csrc/view_unpack.cu`).

Replaces no TPU kernel: the JAX package keeps every training photo's padded
float32 canvas on the device; the port's view store (`data/view_store.py`)
keeps the photos' 8-bit bytes and builds a step's canvas with this kernel.
`launches` counts its launches.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import build
from .expand import _check_input

launches = 0  # launches since the last reset (set to 0 to reset)

_P = ctypes.c_void_p


@functools.lru_cache(maxsize=None)
def _lib():
    lib = build.load("view_unpack")
    lib.r3dgw_view_unpack.argtypes = [_P, _P, _P, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                      ctypes.c_float, ctypes.c_int, ctypes.c_int, _P, _P, _P, _P]
    lib.r3dgw_view_unpack.restype = ctypes.c_int
    return lib


def unpack_view(rgb: torch.Tensor, sky: torch.Tensor | None, occ: torch.Tensor | None,
                background: float | None, out: tuple):
    """Write a photo's padded canvas into out = (image [H, W, 3], sky mask
    [H, W], occluder mask [H, W]) float32, from rgb [h, w, 3] uint8 (or
    [h, w, 4], composited over `background`) and the masks [h, w] uint8 or
    None. For CPU tensors: the plain version (`view_store.unpack_view_plain`)."""
    global launches
    if not rgb.is_cuda:
        from ...data.view_store import unpack_view_plain

        return unpack_view_plain(rgb, sky, occ, background, out)
    dev = rgb.device
    h, w, channels = rgb.shape
    image, sky_out, occ_out = out
    H, W = image.shape[:2]
    if channels not in (3, 4) or (channels == 4) != (background is not None):
        raise ValueError(f"unpack_view: {channels} channels with background {background}")
    if not (h <= H and w <= W and H < 65536 and 3 * H * W < 2 ** 31):
        raise ValueError(f"unpack_view: a {h}x{w} photo on a {H}x{W} canvas")
    _check_input("rgb", rgb, torch.uint8, (h, w, channels), dev, "unpack_view")
    for name, t in (("sky", sky), ("occ", occ)):
        if t is not None:
            _check_input(name, t, torch.uint8, (h, w), dev, "unpack_view")
    for name, t, shape in (("image", image, (H, W, 3)), ("sky_out", sky_out, (H, W)),
                           ("occ_out", occ_out, (H, W))):
        _check_input(name, t, torch.float32, shape, dev, "unpack_view")
        if t.data_ptr() % 16:
            raise ValueError(f"unpack_view: {name} is not 16-byte aligned")
    ptr = lambda t: None if t is None else t.data_ptr()
    lib = _lib()
    with torch.cuda.device(dev):
        err = lib.r3dgw_view_unpack(
            rgb.data_ptr(), ptr(sky), ptr(occ), h, w, channels,
            ctypes.c_float(math.nan if background is None else background), H, W,
            image.data_ptr(), sky_out.data_ptr(), occ_out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    build.check(lib, err, "view_unpack launch")
    launches += 1
    return out
