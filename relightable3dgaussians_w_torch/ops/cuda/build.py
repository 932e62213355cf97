"""Build and load the port's CUDA kernels.

Each source in `relightable3dgaussians_w_torch/csrc/` is compiled by `nvcc` into
a shared library with a plain C interface, at first use, into `build/kernels/`
at the repository root (a directory `.gitignore` lists), and loaded with ctypes.
The library's file name carries a hash of the source and flags, so an edited
source is rebuilt. Nothing is built when a module is imported: the CPU tests
import every module on a machine with no `nvcc`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"

ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
COMMON_FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC"]

# name -> (source file, extra nvcc flags)
KERNELS = {
    "expand": ("expand.cu", []),
    # FMA contraction stays on: the compositor writes its predicate chain (power,
    # alpha, T * (1 - alpha), the packed unpack) with __fmul_rn / __fadd_rn, so
    # those round as the plain version does (ops/composite.py), and lets the
    # blend and the gradient terms contract.
    "tile_composite": ("tile_composite.cu", []),
    "segment_sum": ("segment_sum.cu", []),
    # Contraction off: the row-interval chain rounds each product and sum on
    # its own, as the plain version does (ops/preprocess.py).
    "row_intervals": ("row_intervals.cu", ["--fmad=false"]),
    # Contraction off: the preprocess rounds each product and sum on its own,
    # as the plain chain does (ops/preprocess.py), forward and backward.
    "preprocess": ("preprocess.cu", ["--fmad=false"]),
    # Contraction on: the shading feeds colours and gradients, no predicate;
    # its one sign test (the normal's flip) rounds by hand.
    "shade": ("shade.cu", []),
    # The division by 255 and the composite round by hand (__fdiv_rn,
    # __fmul_rn, ...), as numpy does in the readers.
    "view_unpack": ("view_unpack.cu", []),
}

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def library_path(name: str) -> Path:
    src, extra = KERNELS[name]
    h = hashlib.sha256((SRC_DIR / src).read_bytes())
    h.update(" ".join(ARCH_FLAGS + COMMON_FLAGS + extra).encode())
    return BUILD_DIR / f"{name}_{h.hexdigest()[:12]}.so"


def build(names=None) -> dict[str, Path]:
    """Compile every named kernel that is not built yet, all `nvcc`s at once.
    Raises with the compiler's output if one fails."""
    names = list(KERNELS) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {n: library_path(n) for n in names}
    jobs = []
    for n, out in paths.items():
        if out.exists():
            continue
        src, extra = KERNELS[n]
        fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".tmp.so")
        os.close(fd)
        cmd = [_nvcc(), *ARCH_FLAGS, *COMMON_FLAGS, *extra, "-o", tmp, str(SRC_DIR / src)]
        jobs.append((n, tmp, out, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    errors = []
    for n, tmp, out, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode == 0:
            os.replace(tmp, out)
        else:
            os.unlink(tmp)
            errors.append(f"nvcc failed for {n} (exit {proc.returncode}):\n{log}")
    if errors:
        raise RuntimeError("\n".join(errors))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel, built on first use."""
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build([name])[name]))
        lib.r3dgw_error_string.argtypes = [ctypes.c_int]
        lib.r3dgw_error_string.restype = ctypes.c_char_p
        _loaded[name] = lib
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if err != 0:
        msg = lib.r3dgw_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
