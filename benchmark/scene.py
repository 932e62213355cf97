"""The benchmark's inputs, made from the seed: Gaussian scenes, MLP weights and
embeddings on the device, camera poses, and the training dataset on disk.

Both the program and the reference get what is made here; neither makes its
own. Draws come from `torch.Generator`s on the run's device, in a few large
calls, in float32 (the type the port serves and trains in).
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from .reference.render import Splats


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def uniform(gen, shape, lo, hi, device):
    return torch.rand(shape, generator=gen, device=device) * (hi - lo) + lo


def logit(p: torch.Tensor) -> torch.Tensor:
    return torch.log(p / (1 - p))


def points_in_box(n: int, box, gen, device) -> torch.Tensor:
    """[n, 3] uniform in box = [[x0, x1], [y0, y1], [z0, z1]]."""
    lo = torch.tensor([b[0] for b in box], dtype=torch.float32, device=device)
    hi = torch.tensor([b[1] for b in box], dtype=torch.float32, device=device)
    return torch.rand((n, 3), generator=gen, device=device) * (hi - lo) + lo


def served_scene(sc: dict, seed: int, device) -> Splats:
    """A trained-looking scene: sc["n_foreground"] Gaussians uniform in
    sc["box"], isotropic scales at the density-consistent mean 3-NN distance
    (d2 = anchor_d2 * (anchor_n / n)^(2/3)) jittered by exp(N(0, scale_jitter)),
    random rotations, opacities uniform in sc["opacity_range"], random materials;
    sc["n_sky"] sky Gaussians on a sphere of radius sc["sky_radius"] around the
    origin, theta and phi uniform in their ranges."""
    gen = generator(seed, device)
    n, m = sc["n_foreground"], sc["n_sky"]
    N = n + m
    u = lambda shape, lo, hi: uniform(gen, shape, lo, hi, device)
    xyz = torch.zeros((N, 3), device=device)
    xyz[:n] = points_in_box(n, sc["box"], gen, device)
    d2 = sc["anchor_d2"] * (sc["anchor_n"] / n) ** (2.0 / 3.0)
    log_s = math.log(math.sqrt(d2)) + sc["scale_jitter"] * torch.randn((N, 1), generator=gen,
                                                                      device=device)
    log_s = log_s.expand(N, 3).clone()
    log_s[n:] = math.log(math.sqrt(sc["sky_d2"]))
    rot = torch.randn((N, 4), generator=gen, device=device)
    op = u((N, 1), *sc["opacity_range"])
    sky_angles = torch.zeros((N, 2), device=device)
    sky_angles[n:, 0] = u((m,), *sc["sky_theta"])
    sky_angles[n:, 1] = u((m,), *sc["sky_phi"])
    is_sky = torch.zeros(N, dtype=torch.bool, device=device)
    is_sky[n:] = True
    return Splats(
        xyz=xyz, albedo=torch.randn((N, 3), generator=gen, device=device),
        opacity=logit(op), scaling=log_s, rotation=rot,
        roughness=torch.randn((N, 1), generator=gen, device=device),
        metalness=torch.randn((N, 1), generator=gen, device=device) - 1.0,
        sky_angles=sky_angles,
        sky_radius=torch.tensor(float(sc["sky_radius"]), device=device),
        alive=torch.ones(N, dtype=torch.bool, device=device), is_sky=is_sky,
        sky_center=torch.zeros(3, device=device))


def mlp_weights(model: dict, seed: int, device) -> dict:
    """The illumination MLP's six layers ("dense.{i}.weight" [out, in],
    ".bias" [out]): LeCun-normal weights, biases N(0, 0.1^2)."""
    gen = generator(seed, device)
    d, e = model["mlp_dense"], model["embeddings_dim"]
    envl, sky = (model["envlight_sh_degree"] + 1) ** 2, (model["sky_sh_degree"] + 1) ** 2
    sizes = [(e, d), (d, d), (d, d // 2), (d // 2, sky * 3), (d // 2, d // 2),
             (d // 2, envl * 3)]
    out = {}
    for i, (fi, fo) in enumerate(sizes):
        out[f"dense.{i}.weight"] = torch.randn((fo, fi), generator=gen, device=device) / math.sqrt(fi)
        out[f"dense.{i}.bias"] = 0.1 * torch.randn((fo,), generator=gen, device=device)
    return out


def embeddings(count: int, dim: int, seed: int, device) -> torch.Tensor:
    return torch.randn((count, dim), generator=generator(seed, device), device=device)


# ------------------------------------------------------------------ cameras


def yaw_rotation(deg: float) -> np.ndarray:
    """World -> view rotation of a camera turned by `deg` about the y axis."""
    a = np.deg2rad(deg)
    return np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]])


def orbit_viewmat(deg: float, center) -> np.ndarray:
    """World -> view [4, 4] float64 of a camera yawed by `deg` around `center`,
    at distance center[2] from it (at the origin for 0 degrees)."""
    center = np.asarray(center, np.float64)
    rot = yaw_rotation(deg)
    eye = center - center[2] * rot[2]
    view = np.eye(4)
    view[:3, :3] = rot
    view[:3, 3] = -rot @ eye
    return view


def fovs(width: int, height: int, fov_x_deg: float) -> tuple[float, float]:
    """(fovx, fovy) in radians of a pinhole with square pixels."""
    fx = math.radians(fov_x_deg)
    return fx, 2 * math.atan(math.tan(fx / 2) * height / width)


# ------------------------------------------------------------------ dataset


def write_ply(path: str, fields: dict):
    names = list(fields)
    n = len(fields[names[0]])
    rec = np.empty(n, dtype=np.dtype([(k, "<f4") for k in names]))
    for k in names:
        rec[k] = fields[k]
    head = ["ply", "format binary_little_endian 1.0", f"element vertex {n}"]
    head += [f"property float {k}" for k in names] + ["end_header", ""]
    with open(path, "wb") as f:
        f.write("\n".join(head).encode())
        f.write(rec.tobytes())


def photo(width: int, height: int, gen, device) -> np.ndarray:
    """A smooth [H, W, 3] uint8 photo: a random affine colour ramp (cheap to
    encode; a photo's content does not change a step's work)."""
    c = torch.rand((3, 3), generator=gen, device=device).cpu().numpy()
    y, x = np.mgrid[0:height, 0:width].astype(np.float32)
    img = c[None, None, :, 0] * 0.6 + 0.2 + (c[None, None, :, 1] - 0.5) * 0.3 * (x / width)[..., None] \
        + (c[None, None, :, 2] - 0.5) * 0.3 * (y / height)[..., None]
    return (np.clip(img, 0, 1) * 255).astype(np.uint8)


def training_views(tr: dict, sc: dict) -> list[dict]:
    """The photos' names, yaws and poses: tr["photos"] views on the orbit,
    yaw evenly over tr["yaw_range"] around tr["orbit_center"]."""
    n = tr["photos"]
    lo, hi = tr["yaw_range"]
    out = []
    for i in range(n):
        deg = lo + (hi - lo) * i / max(n - 1, 1)
        out.append({"name": f"view_{i:02d}", "yaw": deg,
                    "viewmat": orbit_viewmat(deg, tr["orbit_center"])})
    return out


def write_colmap_scene(root: str, points: np.ndarray, views: list[dict], photos: list,
                       width: int, height: int, fov_x_deg: float):
    """A COLMAP-layout scene: sparse/0/{cameras,images}.txt (one PINHOLE camera),
    sparse/0/points3D.ply, images/<name>.png."""
    from PIL import Image

    os.makedirs(os.path.join(root, "sparse", "0"))
    os.makedirs(os.path.join(root, "images"))
    fx, fy = fovs(width, height, fov_x_deg)
    focal_x = width / (2 * math.tan(fx / 2))
    focal_y = height / (2 * math.tan(fy / 2))
    lines = []
    for i, (v, img) in enumerate(zip(views, photos)):
        Image.fromarray(img).save(os.path.join(root, "images", v["name"] + ".png"),
                                  compress_level=1)
        a = np.deg2rad(v["yaw"])   # the rotation is a yaw: q = (cos a/2, 0, sin a/2, 0)
        t = v["viewmat"][:3, 3]
        lines += [f"{i + 1} {np.cos(a / 2):.17g} 0 {np.sin(a / 2):.17g} 0 "
                  f"{t[0]:.17g} {t[1]:.17g} {t[2]:.17g} 1 {v['name']}.png", ""]
    with open(os.path.join(root, "sparse", "0", "images.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    with open(os.path.join(root, "sparse", "0", "cameras.txt"), "w") as f:
        f.write(f"1 PINHOLE {width} {height} {focal_x:.17g} {focal_y:.17g} "
                f"{width / 2} {height / 2}\n")
    z = np.zeros(len(points), np.float32)
    g = np.full(len(points), 128.0, np.float32)
    write_ply(os.path.join(root, "sparse", "0", "points3D.ply"),
              {"x": points[:, 0], "y": points[:, 1], "z": points[:, 2], "nx": z, "ny": z,
               "nz": z, "red": g, "green": g, "blue": g})
