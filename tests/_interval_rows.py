"""Hand-made rows for the row-interval pass (`preprocess.row_intervals`).

Shared by the CPU test against the JAX package (tests/test_torch_intervals.py)
and the card test of the row-interval kernel (tests/test_torch_cuda.py); numpy
only, so the card's test file imports no JAX. Each row is a Gaussian's
preprocess output as the pass reads it: mean2d, conic, opacity, rect min / max
and tiles_touched, with the edges the pass has to get right.
"""

import numpy as np

F32_MAX = np.finfo(np.float32).max
I32_MAX = np.iinfo(np.int32).max

# (label, mx, my, a, b, c, opacity, x0, y0, x1, y1, tiles_touched)
_ROWS = [
    ("plain", 40.0, 40.0, 0.01, 0.001, 0.02, 0.8, 0, 0, 6, 6, 36),
    ("nan mx", np.nan, 40.0, 0.01, 0.001, 0.02, 0.8, 0, 0, 6, 6, 36),
    ("nan my", 40.0, np.nan, 0.01, 0.001, 0.02, 0.8, 0, 0, 6, 6, 36),
    ("+inf mx", np.inf, 40.0, 0.01, 0.001, 0.02, 0.8, 0, 0, 6, 6, 36),
    ("-inf my", 40.0, -np.inf, 0.01, 0.001, 0.02, 0.8, 0, 0, 6, 6, 36),
    ("huge mx", 1e30, 40.0, 0.01, 0.001, 0.02, 0.8, 0, 0, 6, 6, 36),
    ("opacity below 1/255", 40.0, 40.0, 0.01, 0.001, 0.02, 0.002, 0, 0, 6, 6, 36),
    ("opacity 0", 40.0, 40.0, 0.01, 0.001, 0.02, 0.0, 0, 0, 6, 6, 36),
    ("opacity nan", 40.0, 40.0, 0.01, 0.001, 0.02, np.nan, 0, 0, 6, 6, 36),
    ("conic zero", 40.0, 40.0, 0.0, 0.0, 0.0, 0.8, 0, 0, 6, 6, 36),
    ("conic det < 0", 40.0, 40.0, 0.01, 0.05, 0.01, 0.8, 0, 0, 6, 6, 36),
    ("conic a < 0", 40.0, 40.0, -0.01, 0.001, 0.02, 0.8, 0, 0, 6, 6, 36),
    ("conic c < 0", 40.0, 40.0, 0.01, 0.001, -0.02, 0.8, 0, 0, 6, 6, 36),
    ("conic inf", 40.0, 40.0, np.inf, 0.0, 0.02, 0.8, 0, 0, 6, 6, 36),
    ("conic nan", 40.0, 40.0, 0.01, np.nan, 0.02, 0.8, 0, 0, 6, 6, 36),
    ("conic denormal", 40.0, 40.0, 1e-40, 0.0, 1e-40, 0.8, 0, 0, 6, 6, 36),
    ("conic huge", 40.0, 40.0, F32_MAX, 0.0, F32_MAX, 0.8, 0, 0, 6, 6, 36),
    ("h > 8, tilted", 60.0, 130.0, 0.02, 0.0139, 0.0104, 0.9, 0, 0, 10, 16, 160),
    ("h > 8, rows cut by the rect", 60.0, 130.0, 0.02, 0.0139, 0.0104, 0.9, 2, 3, 6, 15, 48),
    ("rect width 0", 40.0, 40.0, 0.01, 0.001, 0.02, 0.8, 3, 0, 3, 6, 6),
    ("rect width < 0", 40.0, 40.0, 0.01, 0.001, 0.02, 0.8, 5, 0, 3, 6, 6),
    ("rect height 0", 40.0, 40.0, 0.01, 0.001, 0.02, 0.8, 0, 2, 6, 2, 6),
    ("culled, nonzero rect", 40.0, 40.0, 0.01, 0.001, 0.02, 0.8, 0, 0, 6, 6, 0),
    ("culled, tall rect", 60.0, 130.0, 0.02, 0.0139, 0.0104, 0.9, 0, 0, 10, 16, 0),
    ("txl_rel clamped at 127", 3000.0, 40.0, 0.01, 0.0, 0.01, 0.9, 0, 0, 250, 6, 1500),
    ("wide ellipse, w_j > 127", 2000.0, 40.0, 2e-7, 0.0, 0.01, 0.9, 0, 0, 250, 6, 1500),
    ("negative rect origin", 10.0, 10.0, 0.01, 0.001, 0.02, 0.8, -5, -3, 4, 5, 72),
    ("ty wraps int32", 40.0, 40.0, 0.01, 0.001, 0.02, 0.8, 0, I32_MAX - 3, 6, I32_MAX, 24),
    ("height wraps int32", 40.0, 40.0, 0.01, 0.001, 0.02, 0.8, 0, -5, 6, I32_MAX, 36),
]


def edge_rows(n_random=0, seed=0):
    """The hand-made rows, then `n_random` seeded random ones: a dict of numpy
    arrays mean2d [N, 2], conic [N, 3], opacity [N] (float32), rect_min,
    rect_max [N, 2] and tiles_touched [N] (int32)."""
    v = np.array([r[1:] for r in _ROWS], dtype=np.float64)
    mean2d, conic, op = v[:, 0:2], v[:, 2:5], v[:, 5]
    rects = v[:, 6:10].astype(np.int64)
    touched = v[:, 10].astype(np.int64)
    if n_random:
        rng = np.random.RandomState(seed)
        m = rng.uniform(-50, 850, (n_random, 2))
        sx, sy = rng.uniform(0.5, 60, n_random), rng.uniform(0.5, 60, n_random)
        rho = rng.uniform(-0.9, 0.9, n_random)
        det = (sx * sy) ** 2 * (1 - rho ** 2)
        cn = np.stack([sy ** 2, -rho * sx * sy, sx ** 2], 1) / det[:, None]
        r = np.ceil(3 * np.maximum(sx, sy))
        lo = np.clip(np.floor((m - r[:, None]) / 16), 0, 50)
        hi = np.clip(np.floor((m + r[:, None] + 15) / 16), 0, 50)
        area = (hi - lo).prod(1)
        culled = rng.rand(n_random) < 0.3
        mean2d = np.concatenate([mean2d, m])
        conic = np.concatenate([conic, cn])
        op = np.concatenate([op, rng.uniform(0.0, 1.0, n_random)])
        rects = np.concatenate([rects, np.concatenate([lo, hi], 1).astype(np.int64)])
        touched = np.concatenate([touched, np.where(culled, 0, area).astype(np.int64)])
    return dict(mean2d=mean2d.astype(np.float32), conic=conic.astype(np.float32),
                opacity=op.astype(np.float32), rect_min=rects[:, :2].astype(np.int32),
                rect_max=rects[:, 2:].astype(np.int32), tiles_touched=touched.astype(np.int32))
