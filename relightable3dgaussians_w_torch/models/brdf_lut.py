"""Split-sum environment-BRDF (FG) lookup table, generated on first use.

The port's own numpy copy of the JAX package's `models/brdf_lut.py`: the same
GGX importance-sampled Karis integration with a Hammersley sequence, so the
table is bitwise identical. It is cached as `_fg_lut_256.npy` beside this
module (a name `.gitignore` lists); the cache is written to a temporary file
and moved into place, so processes that generate it at once never read a
partial file.
"""

from __future__ import annotations

import os
import tempfile
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ..ops.texture import pack_bilinear_quads

_CACHE = os.path.join(os.path.dirname(__file__), "_fg_lut_256.npy")
_lut = None
_lut_quad = None


def _hammersley(n: int) -> np.ndarray:
    i = np.arange(n, dtype=np.uint32)
    bits = i.copy()
    bits = ((bits << 16) | (bits >> 16)) & 0xFFFFFFFF
    bits = (((bits & 0x55555555) << 1) | ((bits & 0xAAAAAAAA) >> 1)) & 0xFFFFFFFF
    bits = (((bits & 0x33333333) << 2) | ((bits & 0xCCCCCCCC) >> 2)) & 0xFFFFFFFF
    bits = (((bits & 0x0F0F0F0F) << 4) | ((bits & 0xF0F0F0F0) >> 4)) & 0xFFFFFFFF
    bits = (((bits & 0x00FF00FF) << 8) | ((bits & 0xFF00FF00) >> 8)) & 0xFFFFFFFF
    return np.stack([i.astype(np.float64) / n, bits.astype(np.float64) * 2.3283064365386963e-10], axis=-1)


def _fg_row(r: float, xi: np.ndarray, ndotv: np.ndarray, V: np.ndarray,
            num_samples: int) -> tuple[np.ndarray, np.ndarray]:
    """(A, B) [U] of one roughness row: the JAX package's per-row loop body, op
    for op, so the bits are the same. Only the z component of the reflected
    direction L enters (N = +z), so only that component is formed."""
    a = r * r
    # GGX importance sample around N = +z.
    phi = 2.0 * np.pi * xi[:, 0]
    cos_t = np.sqrt((1.0 - xi[:, 1]) / (1.0 + (a * a - 1.0) * xi[:, 1]))
    sin_t = np.sqrt(np.maximum(1.0 - cos_t**2, 0.0))
    Hs = np.stack([np.cos(phi) * sin_t, np.sin(phi) * sin_t, cos_t], axis=-1)  # [S, 3]

    vdoth = V @ Hs.T                                      # [U, S]
    ndotl = 2.0 * vdoth * Hs[None, :, 2] - V[:, None, 2]  # L = 2 (V.H) H - V, z only
    ndoth = np.maximum(Hs[:, 2], 0.0)[None]               # [U, S]
    nv = ndotv[:, None]

    # Height-correlated Smith masking-shadowing: G = 1 / (1 + L(V) + L(L)).
    a2 = a * a
    lam_v = (np.sqrt(1.0 + a2 * (1.0 - nv**2) / np.maximum(nv**2, 1e-12)) - 1.0) / 2.0
    cl = np.clip(ndotl, 0.0, 1.0)
    lam_l = (np.sqrt(1.0 + a2 * (1.0 - cl**2) / np.maximum(cl**2, 1e-12)) - 1.0) / 2.0
    g = 1.0 / (1.0 + lam_v + lam_l)
    g_vis = g * vdoth / np.maximum(ndoth * nv, 1e-8)
    fc = (1.0 - np.clip(vdoth, 0.0, 1.0)) ** 5
    valid = ndotl > 0
    A = np.where(valid, (1.0 - fc) * g_vis, 0.0).sum(axis=1) / num_samples
    B = np.where(valid, fc * g_vis, 0.0).sum(axis=1) / num_samples
    return A, B


def generate_fg_lut(size: int = 256, num_samples: int = 4096) -> np.ndarray:
    """Returns [size, size, 2] float32: [..., 0] = scale (A), [..., 1] = bias (B);
    u (columns) -> NdotV, v (rows) -> roughness. The rows are independent and
    numpy releases the GIL in its array ops, so a thread pool computes them
    at once."""
    xi = _hammersley(num_samples)  # [S, 2]
    ndotv = (np.arange(size, dtype=np.float64) + 0.5) / size  # columns (u)
    rough = (np.arange(size, dtype=np.float64) + 0.5) / size  # rows (v)

    out = np.zeros((size, size, 2), dtype=np.float64)
    V = np.stack([np.sqrt(1.0 - ndotv**2), np.zeros_like(ndotv), ndotv], axis=-1)  # [U, 3]
    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as pool:
        rows = pool.map(lambda r: _fg_row(r, xi, ndotv, V, num_samples), rough)
        for r_idx, (A, B) in enumerate(rows):
            out[r_idx, :, 0] = A
            out[r_idx, :, 1] = B
    return out.astype(np.float32)


def _save_atomic(path: str, arr: np.ndarray) -> None:
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path), suffix=".npy.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.save(f, arr)
        os.replace(tmp, path)
    except BaseException:
        os.unlink(tmp)
        raise


def get_fg_lut() -> np.ndarray:
    """Cached [256, 256, 2] split-sum LUT."""
    global _lut
    if _lut is None:
        if os.path.exists(_CACHE):
            _lut = np.load(_CACHE)
        else:
            _lut = generate_fg_lut()
            try:
                _save_atomic(_CACHE, _lut)
            except OSError:
                pass  # read-only checkout: regenerate next process
    return _lut


def get_fg_lut_quad() -> np.ndarray:
    """Cached [256, 256, 8] quad-packed LUT (ops/texture.py pack_bilinear_quads)."""
    global _lut_quad
    if _lut_quad is None:
        _lut_quad = pack_bilinear_quads(get_fg_lut())
    return _lut_quad
