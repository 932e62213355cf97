"""The state a relightable 3DGS-W training run starts from, worked out again
from the scene on disk and the run's seed.

The reference repository's `GaussianModel.create_from_pcd` and the sky
seeding of relightable 3DGS-W: one isotropic Gaussian per point with log
scale log(sqrt(mean squared distance to its 3 nearest neighbours)), identity
rotation, opacity 0.1, albedo, roughness and metalness logits 1, 1, 0.1; sky
Gaussians on the upper hemisphere at the 0.99 quantile of the points'
distance from their mean, around the mean camera centre, kept where they
land in the top two thirds of some photo; then the MLP (LeCun-normal weights,
zero biases) and one N(0, 1) embedding per photo. The draws follow the
trainer's order on a CPU `torch.Generator` seeded with the trainer's seed:
the hemisphere's two uniform vectors, the six layers' weights, the
embeddings.

The 3-NN distances are exact, by brute force on the reference's device, for
a sample of rows. The control (`start_gap(control=True)`) puts this state,
computed a precision lower, in the program's place: the 3-NN distances as
matrix products on TF32 operands, the sky positions stored as bfloat16.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import mathops as M

ALBEDO, ROUGHNESS, METALNESS = 1.0, 1.0, 0.1
INIT_OPACITY = float(torch.log(torch.tensor(0.1, dtype=torch.float64) / 0.9))


def colmap_pose(deg: float):
    """The world -> view rotation [3, 3] float64 of a yaw written to COLMAP as
    the quaternion (cos a/2, 0, sin a/2, 0)."""
    a = np.deg2rad(deg)
    w, y = np.cos(a / 2), np.sin(a / 2)
    return np.array([[1 - 2 * y * y, 0.0, 2 * w * y], [0.0, 1.0, 0.0],
                     [-2 * w * y, 0.0, 1 - 2 * y * y]])


def knn_mean_d2(query: torch.Tensor, points: torch.Tensor, query_idx: torch.Tensor,
                block: int = 64, k: int = 3, tf32: bool = False) -> torch.Tensor:
    """Exact mean squared distance of each query point to its k nearest other
    points (itself, by index, left out), in float64; with `tf32`, as
    |q|^2 + |p|^2 - 2 q.p in float32 with the product on TF32 operands."""
    out = []
    for i in range(0, query.shape[0], block):
        if tf32:
            q, p = query[i:i + block].float(), points.float()
            d = ((q * q).sum(1)[:, None] + (p * p).sum(1)[None, :]
                 - 2.0 * M.mm(q, p.t(), tf32=True)).double()
        else:
            q = query[i:i + block].double()
            d = torch.zeros((q.shape[0], points.shape[0]), dtype=torch.float64,
                            device=points.device)
            for c in range(3):
                d += (q[:, None, c] - points[None, :, c].double()) ** 2
        d[torch.arange(q.shape[0], device=d.device), query_idx[i:i + block]] = math.inf
        out.append(torch.topk(d, k, dim=1, largest=False).values.mean(dim=1))
    return torch.cat(out)


def sky_points(points: np.ndarray, viewmats: list, fovx: float, fovy: float, W: int, H: int,
               gen: torch.Generator):
    """(kept hemisphere points [m, 3] float32, sky radius, centre [3] float32)."""
    mean = points.mean(axis=0, keepdims=True)
    radius = float(np.quantile(np.linalg.norm(points - mean, axis=-1), 0.99))
    centers = np.stack([np.linalg.inv(v).astype(np.float32)[:3, 3] for v in viewmats])
    center = centers.mean(axis=0)
    num = int(5000 * radius)
    u_y = torch.rand((num,), generator=gen)
    u_phi = torch.rand((num,), generator=gen)
    y = -0.5 * u_y
    theta = torch.arccos(y)
    phi = (math.pi / 2) * u_phi - math.pi / 4
    pts = torch.stack([torch.sin(phi) * torch.sin(theta), y,
                       torch.sin(theta) * torch.cos(phi)], dim=-1).numpy()
    pts = pts * radius + center[None, :]
    fx, fy = W / (2 * math.tan(fovx / 2)), H / (2 * math.tan(fovy / 2))
    K = np.array([[fx, 0, W / 2.0], [0, fy, H / 2.0], [0, 0, 1.0]], dtype=np.float32)
    keep = np.zeros(num, dtype=bool)
    for v in viewmats:
        p = pts[~keep]
        cam = p @ v[:3, :3].T + v[:3, 3]
        z = cam[:, 2:3]
        with np.errstate(divide="ignore", invalid="ignore"):
            uv = np.where(z > 1e-6, cam[:, :2] / z, np.nan)
        u = K[0, 0] * uv[:, 0] + K[0, 2]
        vv = K[1, 1] * uv[:, 1] + K[1, 2]
        ok = ~np.isnan(np.stack([u, vv], -1)).any(-1) & (vv < (2.0 / 3.0) * H)
        keep[~keep] |= ok
    return pts[keep], radius, center


def mlp_init(model: dict, gen: torch.Generator) -> dict:
    d, e = model["mlp_dense"], model["embeddings_dim"]
    envl, sky = (model["envlight_sh_degree"] + 1) ** 2, (model["sky_sh_degree"] + 1) ** 2
    sizes = [(e, d), (d, d), (d, d // 2), (d // 2, sky * 3), (d // 2, d // 2), (d // 2, envl * 3)]
    out = {}
    for i, (fi, fo) in enumerate(sizes):
        out[f"dense.{i}.weight"] = torch.randn((fo, fi), generator=gen) / math.sqrt(fi)
        out[f"dense.{i}.bias"] = torch.zeros(fo)
    return out


def start_gap(start: dict, pool: dict, points: np.ndarray, viewmats: list, fovx: float,
              fovy: float, W: int, H: int, model: dict, seed: int, n_views: int,
              sample: torch.Tensor, control: bool = False) -> dict:
    """The largest gaps between a program's starting state (`start`: flat
    leaves, `pool`: alive, is_sky, sky_center) and the state worked out here:
    {"exact": max abs gap of the fixed leaves, the MLP and the embeddings (0
    where the program is right: the same draws and constants), "log_scale":
    max abs gap of the sampled rows' log scales, "sky": max gap of the sky
    positions over the sky radius}, all inf where the pools' layouts differ.
    With `control`, the log scales and sky positions compared are the
    control's (see the module's docstring), not the program's."""
    dev = start["gaussians.xyz"].device
    n = points.shape[0]
    gen = torch.Generator().manual_seed(seed)
    sky, radius, center = sky_points(points, viewmats, fovx, fovy, W, H, gen)
    weights = mlp_init(model, gen)
    emb = torch.randn((n_views, model["embeddings_dim"]), generator=gen)
    m = sky.shape[0]
    alive, is_sky = pool["alive"].cpu(), pool["is_sky"].cpu()
    want_alive = torch.zeros_like(alive)
    want_alive[: n + m] = True
    want_sky = torch.zeros_like(is_sky)
    want_sky[n: n + m] = True
    if not (torch.equal(alive, want_alive) and torch.equal(is_sky, want_sky)):
        return {"exact": math.inf, "log_scale": math.inf, "sky": math.inf}

    gap = lambda a, b: float((a.double().cpu() - torch.as_tensor(b).double()).abs().max())
    fg = slice(0, n)
    pts = torch.as_tensor(points, device=dev)
    leaves = [gap(start["gaussians.xyz"][fg], points),
              gap(start["gaussians.albedo"][fg], torch.full((n, 3), ALBEDO)),
              gap(start["gaussians.opacity"][: n + m], torch.full((n + m, 1), INIT_OPACITY)),
              gap(start["gaussians.rotation"][: n + m],
                  torch.tensor([1.0, 0, 0, 0]).expand(n + m, 4)),
              gap(start["gaussians.roughness"][fg], torch.full((n, 1), ROUGHNESS)),
              gap(start["gaussians.metalness"][fg], torch.full((n, 1), METALNESS)),
              gap(start["embeddings"], emb)]
    leaves += [gap(start[f"mlp.{k}"], v) for k, v in weights.items()]
    dead = slice(n + m, None)
    leaves += [gap(start[k][dead], torch.zeros_like(start[k][dead].cpu()))
               for k in start if k.startswith("gaussians.") and k != "gaussians.sky_radius"]

    log_d = lambda q, p, idx, tf32=False: torch.log(torch.sqrt(torch.clamp_min(
        knn_mean_d2(q, p, idx, tf32=tf32), 1e-7)))
    sample = sample.to(dev)
    sky_t = torch.as_tensor(sky, device=dev)
    sky_idx = torch.arange(m, device=dev)
    want, sky_want = log_d(pts[sample], pts, sample), log_d(sky_t, sky_t, sky_idx)
    if control:
        got = log_d(pts[sample], pts, sample, True)[:, None]
        got_sky = log_d(sky_t, sky_t, sky_idx, True)[:, None]
        got_xyz = sky_t.to(torch.bfloat16).double()
    else:
        got = start["gaussians.scaling"][sample].double()
        got_sky = start["gaussians.scaling"][n: n + m].double()
        got_xyz = M.polar_to_cartesian(start["gaussians.sky_angles"][n: n + m].double(),
                                       pool["sky_center"].double(),
                                       start["gaussians.sky_radius"].double())
    log_scale = max(float((got - want[:, None]).abs().max()),
                    float((got_sky - sky_want[:, None]).abs().max()))
    sky_gap = float((got_xyz.cpu() - torch.as_tensor(sky).double()).abs().max()) / radius
    sky_gap = max(sky_gap, abs(float(start["gaussians.sky_radius"]) - radius) / radius,
                  float((pool["sky_center"].cpu().double() - torch.as_tensor(center).double())
                        .abs().max()) / radius)
    return {"exact": max(leaves), "log_scale": log_scale, "sky": sky_gap}
