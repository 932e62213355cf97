"""k-nearest-neighbour mean squared distance for the Gaussian scale
initialisation: port of the JAX package's `ops/knn.py` `knn_dist2`.

Host code, run once per scene: the native C++ box-pruned 3-NN
(`native.py`) when the library builds, else scipy's cKDTree. Both are exact.
The JAX package's on-device approximate `knn_dist2_jax` is not on the
trainer's path and is not ported.
"""

from __future__ import annotations

import numpy as np

from .. import native


def knn_dist2(points: np.ndarray, k: int = 3) -> np.ndarray:
    """Mean squared distance from each point to its k nearest neighbours (exact)."""
    if k <= 8 and native.get_lib() is not None:
        return native.knn_mean_dist2_native(np.asarray(points), k)
    from scipy.spatial import cKDTree

    tree = cKDTree(points)
    d, _ = tree.query(points, k=k + 1)  # the first neighbour is the point itself
    return (d[:, 1:] ** 2).mean(axis=1).astype(np.float32)
