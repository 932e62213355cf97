"""Radiance RGBE (.hdr) images without OpenCV.

The JAX package's `load_hdr_cubemap` reads .hdr with `cv2.imread`. OpenCV
decodes with Bruce Walter's `rgbe.c`; `read_hdr` follows it: the header up to
the blank line, the resolution line, then per scanline either the new
run-length encoding (bytes 2, 2, width; four channel planes of runs and
literals) or flat 4-byte pixels, and each pixel as mantissa * 2^(e - 136) in
float32 (0 where e = 0). `write_hdr` writes flat scanlines.
"""

from __future__ import annotations

import numpy as np

_FLIPS = {("-Y", "+X"): (False, False), ("+Y", "+X"): (True, False),
          ("-Y", "-X"): (False, True), ("+Y", "-X"): (True, True)}


def _decode_rle_scanline(buf: memoryview, pos: int, width: int) -> tuple[np.ndarray, int]:
    """One new-style RLE scanline (after its 4-byte marker) -> [width, 4] uint8."""
    line = np.empty((4, width), np.uint8)
    for ch in range(4):
        i = 0
        while i < width:
            count = buf[pos]
            pos += 1
            if count > 128:   # a run
                count -= 128
                if count == 0 or i + count > width:
                    raise ValueError("bad HDR scanline data")
                line[ch, i:i + count] = buf[pos]
                pos += 1
            else:             # literals
                if count == 0 or i + count > width:
                    raise ValueError("bad HDR scanline data")
                line[ch, i:i + count] = np.frombuffer(buf[pos:pos + count], np.uint8)
                pos += count
            i += count
    return line.T, pos


def read_hdr(path: str) -> np.ndarray:
    """A Radiance .hdr file -> [H, W, 3] float32 RGB."""
    with open(path, "rb") as f:
        data = f.read()
    pos = 0

    def readline():
        nonlocal pos
        end = data.index(b"\n", pos)
        line = data[pos:end].decode("latin-1")
        pos = end + 1
        return line

    if not readline().startswith("#?"):
        raise ValueError(f"{path}: not a Radiance HDR file")
    while readline().strip():
        pass
    parts = readline().split()
    if len(parts) != 4 or (parts[0], parts[2]) not in _FLIPS:
        raise ValueError(f"{path}: unsupported HDR orientation {' '.join(parts)}")
    height, width = int(parts[1]), int(parts[3])
    flip_y, flip_x = _FLIPS[(parts[0], parts[2])]

    buf = memoryview(data)
    rgbe = np.empty((height, width, 4), np.uint8)
    if width < 8 or width > 0x7FFF:   # rgbe.c: no RLE at these widths
        rgbe[:] = np.frombuffer(buf[pos:pos + height * width * 4], np.uint8).reshape(
            height, width, 4)
    else:
        for y in range(height):
            head = bytes(buf[pos:pos + 4])
            if head[0] != 2 or head[1] != 2 or head[2] & 0x80:
                # Not run-length encoded: the rest of the image is flat pixels.
                rest = np.frombuffer(buf[pos:pos + (height - y) * width * 4], np.uint8)
                rgbe[y:] = rest.reshape(height - y, width, 4)
                break
            if (head[2] << 8 | head[3]) != width:
                raise ValueError(f"{path}: wrong scanline width")
            rgbe[y], pos = _decode_rle_scanline(buf, pos + 4, width)
    e = rgbe[..., 3].astype(np.int32)
    scale = np.where(e > 0, np.ldexp(np.float32(1.0), e - 136).astype(np.float32),
                     np.float32(0.0))
    img = rgbe[..., :3].astype(np.float32) * scale[..., None]
    if flip_y:
        img = img[::-1]
    if flip_x:
        img = img[:, ::-1]
    return np.ascontiguousarray(img)


def write_hdr(path: str, img: np.ndarray) -> None:
    """[H, W, 3] float RGB -> a Radiance .hdr file with flat scanlines."""
    img = np.asarray(img, np.float32)
    h, w = img.shape[:2]
    v = img.max(axis=-1)
    mant, e = np.frexp(v)
    scale = np.where(v > 1e-32, mant * 256.0 / np.where(v > 1e-32, v, 1.0), 0.0)
    rgbe = np.zeros((h, w, 4), np.uint8)
    rgbe[..., :3] = np.clip(img * scale[..., None], 0, 255).astype(np.uint8)
    rgbe[..., 3] = np.where(v > 1e-32, e + 128, 0).astype(np.uint8)
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
        f.write(f"-Y {h} +X {w}\n".encode())
        f.write(rgbe.tobytes())
