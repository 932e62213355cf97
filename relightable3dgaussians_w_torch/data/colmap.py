"""COLMAP sparse-reconstruction parsers (binary + text), numpy only.

A copy of the JAX package's `data/colmap.py` (jax-free), from the COLMAP
file-format specification: cameras.bin / images.bin / points3D.bin and their
text twins. Host-side.
"""

from __future__ import annotations

import struct
from typing import NamedTuple

import numpy as np

# COLMAP camera model ids -> (name, num_params).
CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3),
    1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5),
    4: ("OPENCV", 8),
    5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12),
    7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}


class ColmapCamera(NamedTuple):
    id: int
    model: str
    width: int
    height: int
    params: np.ndarray


class ColmapImage(NamedTuple):
    id: int
    qvec: np.ndarray   # (w, x, y, z) world->cam rotation
    tvec: np.ndarray   # world->cam translation
    camera_id: int
    name: str


def qvec2rotmat(q: np.ndarray) -> np.ndarray:
    w, x, y, z = q
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


def _read(f, fmt):
    size = struct.calcsize(fmt)
    return struct.unpack(fmt, f.read(size))


def read_cameras_binary(path: str) -> dict[int, ColmapCamera]:
    cams = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            cam_id, model_id, width, height = _read(f, "<iiQQ")
            name, num_params = CAMERA_MODELS[model_id]
            params = np.array(_read(f, "<" + "d" * num_params))
            cams[cam_id] = ColmapCamera(cam_id, name, int(width), int(height), params)
    return cams


def read_images_binary(path: str) -> dict[int, ColmapImage]:
    images = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            img_id = _read(f, "<i")[0]
            qvec = np.array(_read(f, "<dddd"))
            tvec = np.array(_read(f, "<ddd"))
            (camera_id,) = _read(f, "<i")
            name = b""
            while True:
                c = f.read(1)
                if c == b"\x00":
                    break
                name += c
            (num_points,) = _read(f, "<Q")
            f.seek(num_points * 24, 1)  # skip (x, y, point3D_id) tuples
            images[img_id] = ColmapImage(img_id, qvec, tvec, camera_id, name.decode())
    return images


def read_points3d_binary(path: str):
    """Returns (xyz [N, 3], rgb [N, 3] uint8, error [N]). Uses the native C++
    parser when the library builds (variable-length track records defeat numpy
    vectorization), else this Python loop; both are exact host code."""
    from ..native import read_points3d_binary_native

    out = read_points3d_binary_native(path)
    if out is not None:
        return out
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        xyz = np.empty((n, 3))
        rgb = np.empty((n, 3), dtype=np.uint8)
        err = np.empty(n)
        for i in range(n):
            _read(f, "<Q")  # point id
            xyz[i] = _read(f, "<ddd")
            rgb[i] = _read(f, "<BBB")
            err[i] = _read(f, "<d")[0]
            (track_len,) = _read(f, "<Q")
            f.seek(track_len * 8, 1)
    return xyz, rgb, err


def read_cameras_text(path: str) -> dict[int, ColmapCamera]:
    cams = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            cam_id = int(parts[0])
            cams[cam_id] = ColmapCamera(
                cam_id, parts[1], int(parts[2]), int(parts[3]),
                np.array([float(x) for x in parts[4:]]),
            )
    return cams


def read_images_text(path: str) -> dict[int, ColmapImage]:
    # Two lines per image; the second (2D point list) may be EMPTY for images
    # with no registered observations, so blanks must be kept while pairing
    # (dropping them pairs image lines with each other and silently loses every
    # other camera).
    images = {}
    with open(path) as f:
        lines = [l.strip() for l in f if not l.startswith("#")]
    i = 0
    for line in lines:
        if i % 2 == 0 and line:
            parts = line.split()
            images[int(parts[0])] = ColmapImage(
                int(parts[0]),
                np.array([float(x) for x in parts[1:5]]),
                np.array([float(x) for x in parts[5:8]]),
                int(parts[8]),
                parts[9],
            )
        i += 1
    return images


def read_points3d_text(path: str):
    xyzs, rgbs, errs = [], [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            xyzs.append([float(x) for x in parts[1:4]])
            rgbs.append([int(x) for x in parts[4:7]])
            errs.append(float(parts[7]))
    return np.array(xyzs), np.array(rgbs, dtype=np.uint8), np.array(errs)
