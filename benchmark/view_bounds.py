"""The bound arithmetic of the view store's kernel V (`csrc/view_unpack.cu`
of the port): a launch reads the photo's stored bytes once and writes its
float32 canvas once (the image's 3 floats and the two masks' one each: 20
bytes a canvas pixel), at the card's HBM bandwidth (`roofline.py`'s)."""

from __future__ import annotations

from .roofline import HBM_BYTES_PER_S

CANVAS_BYTES_PER_PIXEL = 20


def unpack_bytes(photo_pixels: float, stored_bytes_per_pixel: float,
                 canvas_pixels: float) -> float:
    return photo_pixels * stored_bytes_per_pixel + canvas_pixels * CANVAS_BYTES_PER_PIXEL


def unpack_bound_s(photo_pixels: float, stored_bytes_per_pixel: float,
                   canvas_pixels: float) -> float:
    """Seconds the launches that covered these pixels need at least."""
    return unpack_bytes(photo_pixels, stored_bytes_per_pixel, canvas_pixels) / HBM_BYTES_PER_S
