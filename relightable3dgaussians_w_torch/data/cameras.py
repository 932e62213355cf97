"""Camera container with precomputed rasterization matrices: port of the JAX
package's `data/cameras.py` (the reference's `Camera`).

A plain dataclass of numpy arrays on the host; `matrices(device)` gives the
rasterizer's `CameraMatrices` as tensors on a device. Matrices use the math
convention (M @ p). A camera that a reader made holds no pixels: its `source`
(`data/readers.PhotoSource`) decodes `image`, `sky_mask` and
`occluders_mask` each time one is read.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np
import torch

from ..ops.rasterize import CameraMatrices
from ..utils.graphics import camera_intrinsics, fov2focal, projection_matrix, world_to_view

ZNEAR = 0.01
ZFAR = 100.0


@dataclass
class Camera:
    uid: int
    colmap_id: int
    R: np.ndarray                 # [3, 3] world-from-cam rotation (COLMAP R^T)
    T: np.ndarray                 # [3] cam-from-world translation
    fovx: float
    fovy: float
    image_name: str
    image: np.ndarray | None      # [H, W, 3] float32 in [0, 1]
    sky_mask: np.ndarray | None   # [H, W] float32, 1 = not sky
    occluders_mask: np.ndarray | None  # [H, W] float32, 1 = keep
    width: int
    height: int
    cx: float | None = None
    cy: float | None = None
    trans: np.ndarray = field(default_factory=lambda: np.zeros(3))
    scale: float = 1.0
    source: object = field(default=None, init=False, repr=False, compare=False)

    def __post_init__(self):
        self.world_view = world_to_view(self.R, self.T, self.trans, self.scale)
        self.proj = projection_matrix(ZNEAR, ZFAR, self.fovx, self.fovy)
        self.full_proj = (self.proj @ self.world_view).astype(np.float32)
        self.c2w = np.linalg.inv(self.world_view).astype(np.float32)
        self.camera_center = self.c2w[:3, 3]

    @property
    def tan_fovx(self) -> float:
        return math.tan(self.fovx * 0.5)

    @property
    def tan_fovy(self) -> float:
        return math.tan(self.fovy * 0.5)

    def matrices(self, device: str | torch.device = "cpu") -> CameraMatrices:
        f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
        return CameraMatrices(
            viewmat=f32(self.world_view),
            projmat=f32(self.full_proj),
            campos=f32(self.camera_center),
            tan_fovx=f32(np.float32(self.tan_fovx)),
            tan_fovy=f32(np.float32(self.tan_fovy)),
        )

    def intrinsics(self) -> np.ndarray:
        return camera_intrinsics(self.fovx, self.fovy, self.width, self.height)

    def project(self, xyz: np.ndarray) -> np.ndarray:
        """World points -> pixel coordinates (pinhole); NaN behind the camera.
        Used by the sky-Gaussian seeding."""
        cam = xyz @ self.world_view[:3, :3].T + self.world_view[:3, 3]
        z = cam[:, 2:3]
        K = self.intrinsics()
        with np.errstate(divide="ignore", invalid="ignore"):
            uv = np.where(z > 1e-6, cam[:, :2] / z, np.nan)
        u = K[0, 0] * uv[:, 0] + K[0, 2]
        v = K[1, 1] * uv[:, 1] + K[1, 2]
        return np.stack([u, v], axis=-1)


def _pixels(name: str) -> property:
    """A pixel field: the array the camera was given, else decoded from its
    source at each read (nothing is kept)."""

    def get(self):
        value = self.__dict__[name]
        if value is None and self.source is not None:
            return getattr(self.source, name)()
        return value

    def put(self, value):
        self.__dict__[name] = value

    return property(get, put)


for _name in ("image", "sky_mask", "occluders_mask"):
    setattr(Camera, _name, _pixels(_name))


def scene_center(cameras: list[Camera]) -> np.ndarray:
    """Mean camera centre."""
    centers = np.stack([c.camera_center for c in cameras], axis=0)
    return centers.mean(axis=0)


def nerfpp_norm(cameras: list[Camera]) -> dict:
    """Scene radius = 1.1 * the largest distance from the mean camera centre."""
    centers = np.stack([c.camera_center for c in cameras], axis=0)
    avg = centers.mean(axis=0, keepdims=True)
    diagonal = np.linalg.norm(centers - avg, axis=1).max()
    return {"translate": -avg[0], "radius": diagonal * 1.1}


def camera_to_json(cam_id: int, cam: Camera) -> dict:
    """SIBR-viewer camera entry: camera-to-world position/rotation + focal
    lengths, written to <model_path>/cameras.json."""
    Rt = np.zeros((4, 4))
    Rt[:3, :3] = cam.R.transpose()
    Rt[:3, 3] = cam.T
    Rt[3, 3] = 1.0
    W2C = np.linalg.inv(Rt)
    return {
        "id": cam_id,
        "img_name": cam.image_name,
        "width": cam.width,
        "height": cam.height,
        "position": W2C[:3, 3].tolist(),
        "rotation": [row.tolist() for row in W2C[:3, :3]],
        "fy": fov2focal(cam.fovy, cam.height),
        "fx": fov2focal(cam.fovx, cam.width),
    }
