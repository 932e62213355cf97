"""The reference training step: leaf inputs -> 13-channel render -> the loss
stack of relightable 3DGS-W -> autograd -> Adam with per-leaf learning rates.

Plain float32 PyTorch over the render of `render.py`, following the
reference repository's `train.py` loss terms and optimizer groups (as the
port's plain step writes them out). Parameters are a flat dict of named
leaves: "gaussians.<field>" (the `Splats` leaves that train), "mlp.<layer
name>" and "embeddings"; the pool's non-trained state (alive, is_sky,
sky_center) comes beside them.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from . import mathops as M
from .render import Camera, Splats, mlp, rasterize, shade_colors, xyz_of

GAUSS_LEAVES = ("xyz", "albedo", "opacity", "scaling", "rotation", "roughness", "metalness",
                "sky_angles", "sky_radius")
SPATIAL_LR_SCALE = 5.0
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-15


class Draws(NamedTuple):
    noise: torch.Tensor   # [25, 3] envlight noise
    keep: torch.Tensor    # [1, 256] bool dropout keep-mask
    dirs: torch.Tensor    # [10, 3] R+ sample directions


class View(NamedTuple):
    cam: Camera
    uid: int
    image: torch.Tensor          # [H, W, 3]
    sky_mask: torch.Tensor       # [H, W], 1 = not sky
    occluders_mask: torch.Tensor  # [H, W], 1 = counts


def splats_of(params: dict, pool: dict) -> Splats:
    return Splats(*[params[f"gaussians.{k}"] for k in GAUSS_LEAVES], pool["alive"],
                  pool["is_sky"], pool["sky_center"])


# ------------------------------------------------------------------ losses


def _masked_mean(x, mask):
    num = torch.sum(mask == 1)
    return torch.where(num > 0, torch.sum(x * mask) / torch.clamp_min(num, 1), 0.0)


def _blur(img, win):
    pad = len(win) // 2

    def along(x, dim):
        padw = [0, 0, 0, 0]
        padw[(2 - dim) * 2:(2 - dim) * 2 + 2] = [pad, pad]
        xp = torch.nn.functional.pad(x, padw)
        n = x.shape[dim]
        acc = None
        for k in range(len(win)):
            term = float(win[k]) * xp.narrow(dim, k, n)
            acc = term if acc is None else acc + term
        return acc

    return along(along(img, 1), 2)


def ssim(img1, img2, mask):
    """SSIM of [C, H, W] images (11 x 11 Gaussian window, sigma 1.5, zero
    padding) averaged over a {0, 1} mask."""
    xs = np.arange(11)
    g = np.exp(-((xs - 5) ** 2) / (2 * 1.5 ** 2))
    win = (g / g.sum()).astype(np.float32)
    mu1, mu2 = _blur(img1, win), _blur(img2, win)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    s1 = _blur(img1 * img1, win) - mu1_sq
    s2 = _blur(img2 * img2, win) - mu2_sq
    s12 = _blur(img1 * img2, win) - mu1_mu2
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    m = ((2 * mu1_mu2 + c1) * (2 * s12 + c2)) / ((mu1_sq + mu2_sq + c1) * (s1 + s2 + c2))
    mask = torch.broadcast_to(mask, m.shape)
    num = torch.sum(mask == 1)
    return torch.where(num > 0, torch.sum(m * mask) / torch.clamp_min(num, 1), 1.0)


def envl_positive_loss(dirs, sh_env, deg):
    """R+ constraint: the envlight's negative values at the sample directions,
    mean of their squares."""
    v = dirs / (torch.linalg.vector_norm(dirs, dim=1, keepdim=True) + 1e-12)
    vals = M.eval_sh(deg, sh_env.transpose(0, 1)[None], v).reshape(-1)
    below = torch.clamp_max(vals, 0.0)
    n = torch.sum(below < 0)
    return torch.where(n > 0, torch.sum(below ** 2) / torch.clamp_min(n, 1), 0.0)


def min_scale_loss(scales, radii, is_sky):
    m = (radii > 0) & (~is_sky)
    n = torch.sum(m)
    return torch.where(n > 0, torch.sum(torch.where(m, torch.amin(scales, -1), 0.0))
                       / torch.clamp_min(n, 1), 0.0)


def sky_depth_loss(depths, is_sky, visible, gamma=0.02):
    sky_m, fg_m = is_sky & visible, (~is_sky) & visible
    n_sky, n_fg = torch.sum(sky_m), torch.sum(fg_m)
    avg_sky = torch.sum(torch.where(sky_m, depths, 0.0)) / torch.clamp_min(n_sky, 1)
    avg_fg = (torch.sum(torch.where(fg_m, depths, 0.0)) / torch.clamp_min(n_fg, 1)).detach()
    return torch.where((n_sky > 0) & (n_fg > 0), torch.exp(-gamma * (avg_sky - avg_fg)), 0.0)


# ------------------------------------------------------------------ step


def loss_of(params: dict, pool: dict, view: View, draws: Draws, step: int, opt: dict, fg_lut,
            envl_deg: int = 4, sky_deg: int = 1, tf32: bool = False):
    """The step's loss, and (radii, visibility) of the render."""
    s = splats_of(params, pool)
    weights = {k[4:]: v for k, v in params.items() if k.startswith("mlp.")}
    e = params["embeddings"][view.uid][None]
    envl, sky = mlp(weights, e, draws.keep, tf32)
    envl = envl[0]
    cam = view.cam
    colors = shade_colors(s, envl + draws.noise, sky, cam.campos, fg_lut, envl_deg, sky_deg,
                          tf32, aov=True)
    xyz = xyz_of(s)
    v = cam.viewmat
    depth_g = xyz[:, 0] * v[2, 0] + xyz[:, 1] * v[2, 1] + xyz[:, 2] * v[2, 2] + v[2, 3]
    colors = torch.cat([colors[:, :9], depth_g[:, None], colors[:, 10:]], dim=-1)
    scales, quats = torch.exp(s.scaling), M.safe_normalize(s.rotation)
    opacity = torch.sigmoid(s.opacity) * s.alive[:, None]
    z = torch.zeros(3, device=xyz.device)
    bg = torch.cat([z, z, z, z[:1], z])
    r = rasterize(xyz, scales, quats, opacity, colors, bg, s.alive, cam)

    img = r.image
    sm = view.sky_mask[..., None]
    normal_map = (img[..., 10:13] - 0.5) * 2.0 * sm + (1.0 - sm)
    c2w = torch.linalg.inv(v)
    normal_ref = M.depth_to_normal(img[..., 9] * view.sky_mask, c2w, cam.tan_fovx, cam.tan_fovy)
    normal_ref = normal_ref * r.alpha.detach()[..., None] + (1.0 - sm)

    chw = lambda x: x.movedim(-1, 0)
    image, gt = chw(img[..., 0:3]), chw(view.image)
    occ3 = torch.broadcast_to(view.occluders_mask[None], image.shape)
    sky3 = torch.broadcast_to(view.sky_mask[None], image.shape)
    l1 = _masked_mean(torch.abs(image - gt), occ3)
    loss = l1 * (1 - opt["lambda_dssim"]) + opt["lambda_dssim"] * (1.0 - ssim(image, gt, occ3))
    diff_c, spec_c = chw(img[..., 3:6]), chw(img[..., 6:9])
    loss = loss + opt["lambda_sky_brdf"] * (_masked_mean(torch.abs(diff_c), 1 - sky3)
                                            + _masked_mean(torch.abs(spec_c), 1 - sky3))
    if opt["lambda_normal"] > 0 and step > opt["reg_normal_from_iter"]:
        rn, rs = chw(normal_map) * occ3 * sky3, chw(normal_ref) * occ3 * sky3
        ncl = opt["lambda_normal"] * torch.mean(1.0 - torch.sum(rn * rs, dim=0))
        loss = loss + ncl
    if opt["lambda_envlight"] > 0:
        loss = loss + envl_positive_loss(draws.dirs, envl, envl_deg)
    radii = r.radii
    if opt["lambda_scale"] > 0:
        loss = loss + opt["lambda_scale"] * min_scale_loss(scales, radii, s.is_sky)
    if opt["lambda_sky_gauss"] > 0 and step > opt["reg_sky_gauss_depth_from_iter"]:
        loss = loss + opt["lambda_sky_gauss"] * sky_depth_loss(r.depth, s.is_sky, radii > 0)
    return loss, radii


def learning_rates(step: int, opt: dict) -> dict:
    """The reference's optimizer groups: leaf name -> learning rate at `step`."""
    t = torch.clamp(torch.tensor(float(step)) / opt["position_lr_max_steps"], 0, 1)
    xyz_lr = float(torch.exp(math.log(opt["position_lr_init"] * SPATIAL_LR_SCALE) * (1 - t)
                             + math.log(opt["position_lr_final"] * SPATIAL_LR_SCALE) * t))
    lrs = {"gaussians.xyz": xyz_lr, "gaussians.sky_angles": xyz_lr,
           "gaussians.albedo": opt["albedo_lr"], "gaussians.opacity": opt["opacity_lr"],
           "gaussians.scaling": opt["scaling_lr"] * SPATIAL_LR_SCALE,
           "gaussians.rotation": opt["rotation_lr"], "gaussians.roughness": opt["roughness_lr"],
           "gaussians.metalness": opt["metalness_lr"],
           "gaussians.sky_radius": opt["sky_radius_lr"],
           "embeddings": 0.0002 if step >= 20_000 else opt["embeddings_lr"]}
    mlp_lr = 0.0002 if step >= 20_000 else opt["mlp_lr"]
    return lrs, mlp_lr


def grads_of(params: dict, pool: dict, view: View, draws: Draws, step: int, opt: dict, fg_lut,
             tf32: bool = False):
    """(loss, {leaf: gradient}) of one step."""
    leaves = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
    loss, _ = loss_of(leaves, pool, view, draws, step, opt, fg_lut, tf32=tf32)
    names = list(leaves)
    gs = torch.autograd.grad(loss, [leaves[k] for k in names], allow_unused=True)
    return float(loss.detach()), {k: torch.zeros_like(leaves[k]) if g is None else g
                                  for k, g in zip(names, gs)}


def adam_step(params: dict, grads: dict, mu: dict, nu: dict, count: int, step: int, opt: dict):
    """One Adam update (eps 1e-15, bias-corrected, optax's op order) with the
    per-leaf learning rates. Returns (params, mu, nu, count)."""
    c = torch.tensor(float(count + 1), dtype=torch.float32)
    bc1 = float(1 - torch.pow(torch.tensor(ADAM_B1, dtype=torch.float32), c))
    bc2 = float(1 - torch.pow(torch.tensor(ADAM_B2, dtype=torch.float32), c))
    lrs, mlp_lr = learning_rates(step, opt)
    new_p, new_mu, new_nu = {}, {}, {}
    for k, p in params.items():
        g = grads[k]
        m = (1 - ADAM_B1) * g + ADAM_B1 * mu[k]
        v = (1 - ADAM_B2) * (g * g) + ADAM_B2 * nu[k]
        u = (m / bc1) / (torch.sqrt(v / bc2) + ADAM_EPS)
        lr = mlp_lr if k.startswith("mlp.") else lrs[k]
        new_p[k], new_mu[k], new_nu[k] = p + (-lr * u), m, v
    return new_p, new_mu, new_nu, count + 1
