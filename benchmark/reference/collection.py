"""The reference for a photo collection: each training photo at its own size
and field of view, laid on one canvas.

A collection's photos come in several sizes; the trainer renders every view
on one canvas, the largest (H, W) of the photos, with the view's own field
of view, and pads photo and masks to it: the image and the sky mask 0 outside
the photo and the occluder mask 0 there too, so padding drops out of every
masked loss (the relightable 3DGS-W trainer's convention for mixed sizes, as
the port's documentation states it). Here each photo and mask is decoded
anew with PIL from the files (a byte over 255, in float32), laid on that
canvas, and fed to `train.py`'s step. The starting state is `init.py`'s, with
the sky seeding's test taken in each camera's own size and field of view:
a hemisphere point is kept where it lands in the top 2/3 of some camera's
height.

Plain float32 PyTorch and numpy; nothing of the port is imported.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from PIL import Image

from . import init as RI
from . import render as RR
from . import train as RT


def fovs(v: dict) -> tuple[float, float]:
    """A PINHOLE camera's fields of view from its written focal length."""
    return (2 * math.atan(v["width"] / (2 * v["focal"])),
            2 * math.atan(v["height"] / (2 * v["focal"])))


def viewmat(v: dict) -> np.ndarray:
    """The world -> view [4, 4] float32 that the written pose reads back as."""
    vm = np.eye(4)
    vm[:3, :3] = RI.colmap_pose(v["yaw"])
    vm[:3, 3] = v["viewmat"][:3, 3]
    return vm.astype(np.float32)


def decode(path: str, mask: bool = False) -> np.ndarray:
    """An 8-bit file over 255 in float32: RGB [h, w, 3], or a mask [h, w]."""
    with Image.open(path) as img:
        img = img.convert("L" if mask else "RGB")
        return np.asarray(img, dtype=np.float32) / 255.0


def canvas(image_path: str, sky_path: str, occ_path: str, H: int, W: int, device):
    """(image [H, W, 3], sky mask [H, W], occluder mask [H, W]) on the canvas."""
    out = []
    for a in (decode(image_path), decode(sky_path, True), decode(occ_path, True)):
        c = np.zeros((H, W) + a.shape[2:], np.float32)
        c[: a.shape[0], : a.shape[1]] = a
        out.append(torch.as_tensor(c, device=device))
    return out


def view(v: dict, image_path: str, sky_path: str, occ_path: str, H: int, W: int, uid: int,
         device) -> RT.View:
    """A training view: the photo's camera rendering the H x W canvas."""
    fx, fy = fovs(v)
    cam = RR.camera(viewmat(v), fx, fy, W, H, device)
    return RT.View(cam, uid, *canvas(image_path, sky_path, occ_path, H, W, device))


def steps(cfg: dict, start: dict, pool: dict, views: list, setup: list, start_step: int, dev,
          fg_lut, tf32: bool = False):
    """The reference's set-up steps from the kept starting state, view i with
    the program's draws of step i: (losses, first gradient norm of each leaf,
    norm of each leaf's change after the steps)."""
    params = {k: v.detach() for k, v in start.items()}
    mu = {k: torch.zeros_like(v) for k, v in params.items()}
    nu = {k: torch.zeros_like(v) for k, v in params.items()}
    count, losses, first = 0, [], None
    for i, (v, (_, draws, _, _)) in enumerate(zip(views, setup)):
        d = RT.Draws(*[x.to(dev) for x in draws])
        loss, grads = RT.grads_of(params, pool, v, d, start_step + i, cfg["optimizer"], fg_lut,
                                  tf32=tf32)
        losses.append(loss)
        if i == 0:
            first = {k: float(torch.linalg.vector_norm(g.double())) for k, g in grads.items()}
        params, mu, nu, count = RT.adam_step(params, grads, mu, nu, count, start_step + i,
                                             cfg["optimizer"])
        del grads
    change = {k: float(torch.linalg.vector_norm((params[k] - start[k]).double())) for k in start}
    return losses, first, change


def sky_points(points: np.ndarray, views: list, gen: torch.Generator):
    """`init.sky_points` with each camera's own size and field of view."""
    mean = points.mean(axis=0, keepdims=True)
    radius = float(np.quantile(np.linalg.norm(points - mean, axis=-1), 0.99))
    vms = [viewmat(v) for v in views]
    center = np.stack([np.linalg.inv(vm).astype(np.float32)[:3, 3] for vm in vms]).mean(axis=0)
    num = int(5000 * radius)
    u_y = torch.rand((num,), generator=gen)
    u_phi = torch.rand((num,), generator=gen)
    y = -0.5 * u_y
    theta = torch.arccos(y)
    phi = (math.pi / 2) * u_phi - math.pi / 4
    pts = torch.stack([torch.sin(phi) * torch.sin(theta), y,
                       torch.sin(theta) * torch.cos(phi)], dim=-1).numpy()
    pts = pts * radius + center[None, :]
    keep = np.zeros(num, dtype=bool)
    for v, vm in zip(views, vms):
        W, H = v["width"], v["height"]
        fovx, fovy = fovs(v)
        fx, fy = W / (2 * math.tan(fovx / 2)), H / (2 * math.tan(fovy / 2))
        K = np.array([[fx, 0, W / 2.0], [0, fy, H / 2.0], [0, 0, 1.0]], dtype=np.float32)
        p = pts[~keep]
        cam = p @ vm[:3, :3].T + vm[:3, 3]
        z = cam[:, 2:3]
        with np.errstate(divide="ignore", invalid="ignore"):
            uv = np.where(z > 1e-6, cam[:, :2] / z, np.nan)
        u = K[0, 0] * uv[:, 0] + K[0, 2]
        vv = K[1, 1] * uv[:, 1] + K[1, 2]
        ok = ~np.isnan(np.stack([u, vv], -1)).any(-1) & (vv < (2.0 / 3.0) * H)
        keep[~keep] |= ok
    return pts[keep], radius, center


def start_gap(start: dict, pool: dict, points: np.ndarray, views: list, model: dict, seed: int,
              sample: torch.Tensor, control: bool = False) -> dict:
    """`init.start_gap` over the collection: its sky seeding is this module's
    `sky_points`, over every photo in the reader's order (by name)."""
    ordered = sorted(views, key=lambda v: v["name"])
    kept = RI.sky_points
    RI.sky_points = lambda pts, _vms, _fx, _fy, _w, _h, gen: sky_points(pts, ordered, gen)
    try:
        return RI.start_gap(start, pool, points, [viewmat(v) for v in ordered], 0.0, 0.0, 0, 0,
                            model, seed, len(ordered), sample, control=control)
    finally:
        RI.sky_points = kept
