"""ctypes loader for the native C++ host library (`native/src/r3dgw_native.cpp`).

The JAX package's `native.py` builds the same source with `make -C native`;
this copy compiles it with its own `g++` command into `build/native/` at the
repository root (a directory `.gitignore` lists), at first use, and never
touches `native/`. The library's file name carries a hash of the source and
flags, so an edited source is rebuilt. It speeds up two host-side steps: COLMAP
points3D.bin parsing and the exact 3-NN of the scale initialisation. The
compiler is the `g++` on PATH, not $CXX: the source needs OpenMP, which a $CXX
toolchain may lack. Where no `g++` is installed, `get_lib` returns None and the
callers take their exact Python / scipy paths; a compiler that fails raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np

_ROOT = Path(__file__).resolve().parents[1]
SOURCE = _ROOT / "native" / "src" / "r3dgw_native.cpp"
BUILD_DIR = _ROOT / "build" / "native"
CXXFLAGS = ["-O3", "-march=native", "-fPIC", "-fopenmp", "-std=c++17", "-shared"]


def library_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXXFLAGS).encode())
    return BUILD_DIR / f"r3dgw_native_{h.hexdigest()[:12]}.so"


def build() -> Path | None:
    """Compile the library if it is not built yet; None when there is no C++
    compiler. Raises with the compiler's output if the build fails."""
    out = library_path()
    if out.exists():
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".tmp.so")
    os.close(fd)
    proc = subprocess.run([cxx, *CXXFLAGS, "-o", tmp, str(SOURCE)], capture_output=True,
                          text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"building {SOURCE.name} failed:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


@functools.lru_cache(maxsize=None)
def get_lib():
    """The loaded library, or None when it cannot be built here (no compiler)."""
    path = build()
    if path is None:
        return None
    lib = ctypes.CDLL(str(path))
    lib.colmap_count_points3d.restype = ctypes.c_longlong
    lib.colmap_count_points3d.argtypes = [ctypes.c_char_p]
    lib.colmap_read_points3d.restype = ctypes.c_longlong
    lib.colmap_read_points3d.argtypes = [
        ctypes.c_char_p,
        np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
        ctypes.c_longlong,
    ]
    lib.knn_mean_dist2.restype = ctypes.c_int
    lib.knn_mean_dist2.argtypes = [
        np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
        ctypes.c_longlong, ctypes.c_int,
        np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
    ]
    return lib


def read_points3d_binary_native(path: str):
    """Native points3D.bin parser; (xyz, rgb, err), or None without the library
    or when the file is not a readable points3D.bin."""
    lib = get_lib()
    if lib is None:
        return None
    n = lib.colmap_count_points3d(path.encode())
    if n < 0:
        return None
    xyz = np.empty((n, 3), np.float64)
    rgb = np.empty((n, 3), np.uint8)
    err = np.empty(n, np.float64)
    if lib.colmap_read_points3d(path.encode(), xyz, rgb, err, n) != n:
        return None
    return xyz, rgb, err


def knn_mean_dist2_native(points: np.ndarray, k: int = 3):
    """Native exact k-NN mean squared distance ([n] float32), or None without the
    library."""
    lib = get_lib()
    if lib is None:
        return None
    pts = np.ascontiguousarray(points, np.float32)
    out = np.empty(len(pts), np.float32)
    if lib.knn_mean_dist2(pts, len(pts), k, out) != 0:
        raise RuntimeError(f"knn_mean_dist2 failed for {len(pts)} points, k={k}")
    return out
