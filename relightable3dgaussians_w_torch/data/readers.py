"""Scene readers: NeRF-OSR / COLMAP / Blender, host-side.

Port of the JAX package's `data/readers.py` (the reference's
`scene/dataset_readers.py` with the resolution policy of
`utils/camera_utils.py`: images wider than 1.6k are downscaled).

A reader sizes each photo from its file's header and decodes nothing: each
`Camera` gets a `PhotoSource`. One decoder reads the files with PIL to their
8-bit bytes (`PhotoSource.image_u8`, `mask_u8`); a camera's `image`,
`sky_mask` and `occluders_mask` are those bytes over 255 (float32 HWC numpy
in [0, 1], masks [H, W] float32, as the JAX package's readers give them),
made when read and not kept. The trainer's view store (`data/view_store.py`)
keeps the bytes, decoded on a thread pool (`decode_each`), so no float32 copy
of a training collection is made.
"""

from __future__ import annotations

import json
import os
from concurrent.futures import ThreadPoolExecutor
from typing import NamedTuple

import numpy as np
from PIL import Image

from ..utils.graphics import focal2fov, fov2focal, BasicPointCloud
from . import colmap
from .cameras import Camera, nerfpp_norm
from .ply import read_ply, write_ply


class SceneInfo(NamedTuple):
    point_cloud: BasicPointCloud
    train_cameras: list
    test_cameras: list
    nerf_normalization: dict
    ply_path: str


def _resolve_resolution(orig_w: int, orig_h: int, resolution: int, resolution_scale: float = 1.0):
    """-1 => cap width at 1600; {1,2,4,8} => divide; other
    positive values => target width."""
    if resolution in (1, 2, 4, 8):
        return round(orig_w / (resolution_scale * resolution)), round(orig_h / (resolution_scale * resolution))
    if resolution == -1:
        global_down = orig_w / 1600 if orig_w > 1600 else 1
    else:
        global_down = orig_w / resolution
    scale = float(global_down) * float(resolution_scale)
    return int(orig_w / scale), int(orig_h / scale)


# A byte over 255 in float32, as numpy divides: every photo and mask is read
# as this table at its bytes (the view store's kernel V uses the same).
UNIT = np.arange(256, dtype=np.float32) / 255.0


def _u8(img: Image.Image, path: str) -> np.ndarray:
    arr = np.array(img)      # writable, so torch.from_numpy takes it as it is
    if arr.dtype != np.uint8:
        raise ValueError(f"{path}: {img.mode} pixels; photos and masks are read as 8-bit")
    return arr


class PhotoSource(NamedTuple):
    """Where a camera's photo and masks are decoded from, at what size.

    COLMAP and NeRF-OSR photos (`background` None) give RGB: a grey photo
    repeated over three channels, extra channels dropped. A Blender frame
    (`background` set) with alpha is composited over the background."""
    image_path: str
    size: tuple                           # (W, H) after the resolution policy
    sky_mask_path: str | None = None
    occluders_mask_path: str | None = None
    background: float | None = None

    def image(self) -> np.ndarray:
        """[H, W, 3] float32: `image_u8()` over 255, an RGBA frame composited
        over the background."""
        arr = UNIT[self.image_u8()]
        if arr.shape[-1] == 4:
            arr = arr[..., :3] * arr[..., 3:4] + self.background * (1 - arr[..., 3:4])
        return arr

    def sky_mask(self) -> np.ndarray | None:
        m = self.mask_u8("sky_mask")
        return None if m is None else UNIT[m]

    def occluders_mask(self) -> np.ndarray | None:
        m = self.mask_u8("occluders_mask")
        return None if m is None else UNIT[m]

    def image_u8(self) -> np.ndarray:
        """[H, W, 3] uint8 (a Blender frame with alpha: [H, W, 4]). Photos
        are 8-bit: another depth raises."""
        with Image.open(self.image_path) as img:
            arr = _u8(img.resize(self.size), self.image_path)
        if self.background is None:
            if arr.ndim == 2:
                arr = arr[..., None].repeat(3, axis=-1)
            arr = arr[..., :3]
        elif arr.ndim != 3 or arr.shape[-1] not in (3, 4):
            raise ValueError(f"{self.image_path}: {arr.shape} pixels, RGB or RGBA expected")
        return np.ascontiguousarray(arr)

    def mask_u8(self, which: str) -> np.ndarray | None:
        """[H, W] uint8 of "sky_mask" or "occluders_mask" (None where the
        camera has none)."""
        path = getattr(self, which + "_path")
        if not path or not os.path.exists(path):
            return None
        with Image.open(path) as m:
            return _u8(m.convert("L").resize(self.size), path)


def decode_each(items, fn, workers: int | None = None):
    """fn(item) for each item on a thread pool (PIL releases the GIL while it
    decodes), yielded in order; at most 2 x workers results are held at once."""
    items = list(items)
    workers = workers or min(16, os.cpu_count() or 1)
    window = 2 * workers
    with ThreadPoolExecutor(workers) as pool:
        pending = [pool.submit(fn, x) for x in items[:window]]
        for i in range(len(items)):
            out = pending[i].result()
            pending[i] = None
            if i + window < len(items):
                pending.append(pool.submit(fn, items[i + window]))
            yield out


class CameraInfo(NamedTuple):
    uid: int
    R: np.ndarray
    T: np.ndarray
    fovx: float
    fovy: float
    cx: float | None
    cy: float | None
    image_path: str
    image_name: str
    sky_mask_path: str | None
    occluders_mask_path: str | None
    width: int
    height: int


def _read_colmap_cameras(path: str, images_dir: str, sky_masks_dir: str | None,
                         occluders_dir: str | None, masks_extension: str = ".png"):
    sparse = os.path.join(path, "sparse/0")
    try:
        extr = colmap.read_images_binary(os.path.join(sparse, "images.bin"))
        intr = colmap.read_cameras_binary(os.path.join(sparse, "cameras.bin"))
    except FileNotFoundError:
        extr = colmap.read_images_text(os.path.join(sparse, "images.txt"))
        intr = colmap.read_cameras_text(os.path.join(sparse, "cameras.txt"))

    infos = []
    for key in extr:
        im = extr[key]
        cam = intr[im.camera_id]
        R = colmap.qvec2rotmat(im.qvec).T
        T = np.array(im.tvec)
        cx = cy = None
        if cam.model == "SIMPLE_PINHOLE":
            fovx = focal2fov(cam.params[0], cam.width)
            fovy = focal2fov(cam.params[0], cam.height)
        elif cam.model == "PINHOLE":
            fovx = focal2fov(cam.params[0], cam.width)
            fovy = focal2fov(cam.params[1], cam.height)
            cx, cy = float(cam.params[-2]), float(cam.params[-1])
        else:
            raise ValueError(f"unsupported COLMAP model {cam.model}; undistort first")
        name = os.path.basename(im.name)
        stem = name.split(".")[0]
        infos.append(
            CameraInfo(
                uid=cam.id, R=R, T=T, fovx=fovx, fovy=fovy, cx=cx, cy=cy,
                image_path=os.path.join(images_dir, name), image_name=stem,
                sky_mask_path=os.path.join(sky_masks_dir, stem + "_mask" + masks_extension) if sky_masks_dir else None,
                occluders_mask_path=os.path.join(occluders_dir, stem + masks_extension) if occluders_dir else None,
                width=cam.width, height=cam.height,
            )
        )
    return sorted(infos, key=lambda c: c.image_name)


def _photo_size(path: str, resolution: int, resolution_scale: float = 1.0):
    with Image.open(path) as probe:
        ow, oh = probe.size
    return _resolve_resolution(ow, oh, resolution, resolution_scale)


def _lazy_camera(source: PhotoSource, **fields) -> Camera:
    cam = Camera(image=None, sky_mask=None, occluders_mask=None, width=source.size[0],
                 height=source.size[1], **fields)
    cam.source = source
    return cam


def _materialize(infos, resolution: int, resolution_scale: float = 1.0) -> list[Camera]:
    """Cameras sized from their files' headers; pixels are decoded when read."""
    cams = []
    for i, info in enumerate(infos):
        size = _photo_size(info.image_path, resolution, resolution_scale)
        src = PhotoSource(info.image_path, size, info.sky_mask_path, info.occluders_mask_path)
        cams.append(_lazy_camera(src, uid=i, colmap_id=info.uid, R=info.R, T=info.T,
                                 fovx=info.fovx, fovy=info.fovy, image_name=info.image_name,
                                 cx=info.cx, cy=info.cy))
    return cams


def _load_point_cloud(path: str) -> tuple[BasicPointCloud, str]:
    sparse = os.path.join(path, "sparse/0")
    ply_path = os.path.join(sparse, "points3D.ply")
    if not os.path.exists(ply_path):
        try:
            xyz, rgb, _ = colmap.read_points3d_binary(os.path.join(sparse, "points3D.bin"))
        except FileNotFoundError:
            xyz, rgb, _ = colmap.read_points3d_text(os.path.join(sparse, "points3D.txt"))
        write_ply(ply_path, {
            "x": xyz[:, 0], "y": xyz[:, 1], "z": xyz[:, 2],
            "nx": np.zeros(len(xyz)), "ny": np.zeros(len(xyz)), "nz": np.zeros(len(xyz)),
            "red": rgb[:, 0], "green": rgb[:, 1], "blue": rgb[:, 2],
        })
    v = read_ply(ply_path)
    pts = np.stack([v["x"], v["y"], v["z"]], axis=-1)
    if "red" in v:
        cols = np.stack([v["red"], v["green"], v["blue"]], axis=-1)
        cols = cols / 255.0 if cols.max() > 1.5 else cols
    else:
        cols = np.full_like(pts, 0.5)
    normals = (
        np.stack([v["nx"], v["ny"], v["nz"]], axis=-1) if "nx" in v else np.zeros_like(pts)
    )
    return BasicPointCloud(points=pts, colors=cols, normals=normals), ply_path


def read_nerfosr_info(path: str, images: str | None, eval: bool, resolution: int = -1,
                      masks_extension: str = ".png") -> SceneInfo:
    """NeRF-OSR layout: COLMAP sparse/0 + sky_masks/ + masks/ + train/rgb, test/rgb
    split listings."""
    reading_dir = images or "images"
    infos = _read_colmap_cameras(
        path, os.path.join(path, reading_dir), os.path.join(path, "sky_masks"),
        os.path.join(path, "masks"), masks_extension,
    )
    train_names = {n.split(".")[0] for n in os.listdir(os.path.join(path, "train/rgb"))}
    train_infos = [c for c in infos if c.image_name in train_names]
    if eval:
        test_names = {n.split(".")[0] for n in os.listdir(os.path.join(path, "test/rgb"))}
        test_infos = [c for c in infos if c.image_name in test_names]
    else:
        test_infos = []

    train_cams = _materialize(train_infos, resolution)
    test_cams = _materialize(test_infos, resolution)
    pcd, ply_path = _load_point_cloud(path)
    return SceneInfo(pcd, train_cams, test_cams, nerfpp_norm(train_cams), ply_path)


def read_colmap_info(path: str, images: str | None, eval: bool, resolution: int = -1,
                     llffhold: int = 8) -> SceneInfo:
    """Generic COLMAP scene with every llffhold-th camera held out."""
    infos = _read_colmap_cameras(path, os.path.join(path, images or "images"), None, None)
    if eval:
        train_infos = [c for i, c in enumerate(infos) if i % llffhold != 0]
        test_infos = [c for i, c in enumerate(infos) if i % llffhold == 0]
    else:
        train_infos, test_infos = infos, []
    train_cams = _materialize(train_infos, resolution)
    test_cams = _materialize(test_infos, resolution)
    pcd, ply_path = _load_point_cloud(path)
    return SceneInfo(pcd, train_cams, test_cams, nerfpp_norm(train_cams), ply_path)


def read_blender_info(path: str, white_background: bool, eval: bool,
                      resolution: int = -1, extension: str = ".png") -> SceneInfo:
    """Blender transforms_{train,test}.json scenes, with a random point-cloud
    init when no ply exists."""

    def read_split(transformsfile):
        cams = []
        with open(os.path.join(path, transformsfile)) as f:
            meta = json.load(f)
        fovx = meta["camera_angle_x"]
        for i, frame in enumerate(meta["frames"]):
            file_path = os.path.join(path, frame["file_path"] + extension)
            c2w = np.array(frame["transform_matrix"])
            c2w[:3, 1:3] *= -1  # blender (Y up, Z back) -> COLMAP (Y down, Z fwd)
            w2c = np.linalg.inv(c2w)
            R = np.transpose(w2c[:3, :3])
            T = w2c[:3, 3]
            size = _photo_size(file_path, resolution)
            fovy = focal2fov(fov2focal(fovx, size[0]), size[1])
            src = PhotoSource(file_path, size, background=1.0 if white_background else 0.0)
            cams.append(_lazy_camera(src, uid=i, colmap_id=i, R=R, T=T, fovx=fovx, fovy=fovy,
                                     image_name=os.path.basename(frame["file_path"])))
        return cams

    train_cams = read_split("transforms_train.json")
    test_cams = read_split("transforms_test.json") if eval else []
    ply_path = os.path.join(path, "points3d.ply")
    if not os.path.exists(ply_path):
        n = 100_000
        rng = np.random.RandomState(0)
        xyz = rng.random((n, 3)) * 2.6 - 1.3
        rgb = rng.random((n, 3))
        write_ply(ply_path, {
            "x": xyz[:, 0], "y": xyz[:, 1], "z": xyz[:, 2],
            "nx": np.zeros(n), "ny": np.zeros(n), "nz": np.zeros(n),
            "red": rgb[:, 0] * 255, "green": rgb[:, 1] * 255, "blue": rgb[:, 2] * 255,
        })
    v = read_ply(ply_path)
    pts = np.stack([v["x"], v["y"], v["z"]], axis=-1)
    cols = np.stack([v["red"], v["green"], v["blue"]], axis=-1)
    cols = cols / 255.0 if cols.max() > 1.5 else cols
    pcd = BasicPointCloud(points=pts, colors=cols, normals=np.zeros_like(pts))
    return SceneInfo(pcd, train_cams, test_cams, nerfpp_norm(train_cams), ply_path)


def load_scene_info(source_path: str, images: str | None = None, eval: bool = False,
                    resolution: int = -1, white_background: bool = False) -> SceneInfo:
    """Dataset dispatch by path sniffing."""
    if os.path.exists(os.path.join(source_path, "train", "rgb")):
        return read_nerfosr_info(source_path, images, eval, resolution)
    if os.path.exists(os.path.join(source_path, "sparse")):
        return read_colmap_info(source_path, images, eval, resolution)
    if os.path.exists(os.path.join(source_path, "transforms_train.json")):
        return read_blender_info(source_path, white_background, eval, resolution)
    raise ValueError(f"could not identify scene type in {source_path}")
