"""The seeded synthetic scene and camera of the repository's entry module
(`__graft_entry__._synthetic_scene` / `_camera`), built with the same numpy
RandomState draws so both packages get the same scene from a seed."""

from __future__ import annotations

import numpy as np
import torch

from .models import gaussians as G
from .ops.rasterize import CameraMatrices
from .utils.graphics import projection_matrix


def synthetic_scene(n=10_000, n_sky=500, cap=None, seed=0, d2=None,
                    device: str | torch.device = "cpu"):
    """n foreground points uniform in [-2,2]^2 x [1,8] plus n_sky sky Gaussians
    on a radius-20 shell; `d2` is the mean 3-NN squared distance driving the
    init scales (0.008 by default; large pools pass ~(volume/n)^(2/3))."""
    rng = np.random.RandomState(seed)
    pts = np.stack([
        rng.uniform(-2, 2, n), rng.uniform(-2, 2, n), rng.uniform(1.0, 8.0, n)
    ], axis=-1).astype(np.float32)
    d2 = np.full(n, 0.008 if d2 is None else d2, np.float32)
    cap = cap or (n + n_sky)
    params, state = G.init_from_points(pts, d2, cap, device=device)
    theta = rng.uniform(0.1, 1.4, n_sky)
    phi = rng.uniform(-1.4, 1.4, n_sky)
    R = 20.0
    sky_pts = np.stack([
        R * np.sin(theta) * np.sin(phi), -R * np.cos(theta), R * np.sin(theta) * np.cos(phi)
    ], axis=-1).astype(np.float32)
    return G.augment_with_sky(params, state, sky_pts, np.full(n_sky, 0.5, np.float32), R,
                              np.zeros(3, np.float32))


def camera(W, H, fov_deg=60.0, viewmat: np.ndarray | None = None,
           device: str | torch.device = "cpu") -> CameraMatrices:
    """Camera at the origin looking down +z (or at `viewmat`), square fov."""
    fov = np.deg2rad(fov_deg)
    view = np.eye(4, dtype=np.float32) if viewmat is None else np.asarray(viewmat, np.float32)
    proj = projection_matrix(0.01, 100.0, fov, fov)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    return CameraMatrices(
        viewmat=f32(view),
        projmat=f32(proj @ view),
        campos=f32(np.linalg.inv(view)[:3, 3]),
        tan_fovx=f32(np.tan(fov / 2)),
        tan_fovy=f32(np.tan(fov / 2)),
    )
