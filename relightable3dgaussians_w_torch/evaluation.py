"""Evaluation: test-embedding fitting, GT-envmap relighting, white light and
the half-image metric protocol.

Port of the JAX package's `evaluation.py` (the reference's
`optimize_embeddings_test`, `eval_with_gt_envmaps.py`, `eval_with_white_light.py`
and the `evaluate_half` protocol of `metrics.py`: embeddings are fitted on the
LEFT half of each test image and scored on the RIGHT half).

Views are the padded view dicts of `trainer.pad_cameras` (`cam`, `image`,
`sky_mask`, `occluders_mask` as numpy). Every function renders on `device`
(CUDA unless the caller asks for the CPU): the renders go through the port's
rasterizer, so on the card the embedding fit launches kernels A, B (13
channels), C and D, and the relighting sweep composites its 17 fused sun
angles as 51 channels of kernel B.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch.func import functional_call

from .config import Config
from .device import resolve_device
from .models import gaussians as G
from .models import light as L
from .models.nets import MLPNet
from .ops.rasterize import RasterizerConfig, rasterize
from .renderer import render
from .train_step import AdamState, adam_update
from .utils import envmap as EM
from .utils import losses as LO

ADAM_EPS = 1e-8   # optax.adam's default (the training step's Adam uses 1e-15)
WHITE_DC = 1.0 / 0.886227   # DC coefficient whose degree-0 irradiance is 1


def left_half(img):
    """Left vertical half along the width of an [H, W, ...] image."""
    return img[:, : img.shape[1] // 2]


def right_half(img):
    return img[:, img.shape[1] // 2:]


def _view_on(view: dict, dev: torch.device):
    """(camera matrices, image [H, W, 3], sky mask, occluder mask) on `dev`."""
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    return (view["cam"].matrices(dev), t(view["image"]), t(view["sky_mask"]),
            t(view["occluders_mask"]))


def optimize_test_embeddings(params, gauss_state: G.GaussianState, mlp: MLPNet, test_views,
                             cfg: Config, rcfg: RasterizerConfig, init_embeddings,
                             iters: int | None = None, seed: int = 0,
                             device: str | torch.device = "cuda") -> torch.Tensor:
    """Fit per-test-image embeddings on the LEFT half of each test image with the
    L1 + SSIM objective; every other parameter stays fixed.

    Args:
        params: {"gaussians", "mlp", "embeddings"} (the trainer's parameters).
        test_views: padded view dicts.
        init_embeddings: [T, D] initialization.
        iters: Adam steps (default `optimizer.optim_embeddings_test_iters`); the
            views are visited in the JAX package's `np.random.RandomState(seed)`
            order.
    Returns:
        [T, D] fitted embeddings on `device`.
    """
    dev = resolve_device(device)
    o, m = cfg.optimizer, cfg.model
    iters = iters or o.optim_embeddings_test_iters
    gauss = G.to_device(G.GaussianParams(*[x.detach() for x in params["gaussians"]]), dev)
    gstate = G.to_device(gauss_state, dev)
    mlp_params = {k: v.detach().to(dev) for k, v in params["mlp"].items()}
    bg = torch.zeros(3, device=dev)
    W2 = rcfg.width // 2
    views = [_view_on(v, dev) for v in test_views]

    def loss_fn(emb, i):
        cam, gt, sky, occ = views[i]
        envl, sky_sh = functional_call(mlp, mlp_params, (emb[i][None],))
        out = render(gauss, gstate, envl[0], sky_sh, cam, rcfg, bg, sky,
                     m.envlight_sh_degree, m.sky_sh_degree, m.specular, m.fix_sky,
                     debug=False, device=dev)
        img_l = out.render[:, :W2].movedim(-1, 0)
        gt_l = gt[:, :W2].movedim(-1, 0)
        occ_l = occ[None, :, :W2].expand_as(img_l)
        l1 = LO.l1_loss(img_l, gt_l, mask=occ_l)
        s = 1.0 - LO.ssim(img_l, gt_l, mask=occ_l)
        return l1 * (1 - o.lambda_dssim) + o.lambda_dssim * s

    emb = torch.as_tensor(init_embeddings, dtype=torch.float32).to(dev).contiguous()
    zeros = torch.zeros_like(emb)
    opt = AdamState(torch.zeros((), dtype=torch.int32, device=dev), zeros, zeros)
    rng = np.random.RandomState(seed)
    stack: list[int] = []
    for _ in range(iters):
        if not stack:
            stack = list(range(len(views)))
        i = stack.pop(rng.randint(len(stack)))
        emb = emb.detach().requires_grad_(True)
        (grad,) = torch.autograd.grad(loss_fn(emb, i), emb)
        updates, opt = adam_update(grad, opt, eps=ADAM_EPS)
        emb = emb.detach() + (-o.embeddings_lr) * updates   # optax: scale(-lr), then add
    return emb.detach()


class RelightResult(NamedTuple):
    image: np.ndarray
    best_angle: float
    psnr: float
    mae: float
    mse: float
    angle_psnrs: np.ndarray   # [n_angles] masked PSNR of each swept sun angle


@torch.no_grad()
def eval_view_with_gt_envmap(params, gauss_state: G.GaussianState, cfg: Config,
                             rcfg: RasterizerConfig, view: dict, envmap_img: np.ndarray,
                             eval_mask: np.ndarray, init_rot=(0.0, 0.0, 0.0),
                             sun_angle_range=(0.0, 2 * np.pi), n_angles: int = 51,
                             threshold: float = 0.999, scale: float = 10.0, bg=None,
                             angle_batch: int = 17,
                             device: str | torch.device = "cuda") -> RelightResult:
    """Relight one test view with its GT envmap: project to SH, apply the
    initial rotation, sweep `n_angles` sun rotations about y, keep the best
    masked PSNR (fix_sky: white sky).

    The sweep is batched: `angle_batch` rotations ride one rasterize as 3 x
    angle_batch fused color channels (51 at the default 17), since the tile
    geometry, binning and per-pixel alpha do not depend on the light; the last
    group is padded with its last angle so every group has one shape. Then one
    render at the winning angle gives the returned image and metrics."""
    dev = resolve_device(device)
    m = cfg.model
    img = EM.saturate_envmap(envmap_img, threshold, scale)
    coeffs = EM.project_envmap_to_sh(img, m.envlight_sh_degree)
    rz, ry, rx = init_rot[2], init_rot[1], init_rot[0]
    base0 = EM.rotate_sh(coeffs, yaw=rz, pitch=ry, roll=rx)

    bg = torch.zeros(3, device=dev) if bg is None else torch.as_tensor(bg, device=dev)
    sky_sh = torch.zeros((1, (m.sky_sh_degree + 1) ** 2, 3), device=dev)
    cam, gt, sky, _ = _view_on(view, dev)
    mask = torch.as_tensor(np.asarray(eval_mask, np.float32), device=dev)

    p = G.to_device(params["gaussians"], dev)
    gstate = G.to_device(gauss_state, dev)
    xyz = G.get_xyz(p, gstate)
    normal = G.get_normal(p, L.safe_normalize(xyz - cam.campos[None, :]))
    albedo, kr, km = G.get_albedo(p), G.get_roughness(p), G.get_metalness(p)
    geometry = (xyz, G.get_scaling(p), G.get_rotation(p), G.get_opacity(p, gstate))

    def sweep_group(bases):
        """bases [nb, K, 3] -> masked PSNR [nb] from one fused rasterize."""
        nb = bases.shape[0]
        colors = []
        for base in bases:
            shaded = L.shade(base, m.envlight_sh_degree, xyz, normal, albedo, cam.campos,
                             kr, km, specular=m.specular)
            colors.append(torch.where(gstate.is_sky[:, None], 1.0, shaded.rgb))  # fix_sky
        colors = torch.stack(colors, dim=1).reshape(xyz.shape[0], nb * 3)
        image, _ = rasterize(*geometry, colors, bg.repeat(nb), cam, rcfg,
                             active=gstate.alive, device=dev)
        ims = torch.clamp(image.reshape(image.shape[0], image.shape[1], nb, 3), 0, 1)
        se = torch.sum((ims - gt[:, :, None, :]) ** 2 * mask[:, :, None, None], dim=(0, 1, 3))
        return LO.mse2psnr(se / (torch.sum(mask) * 3 + 1e-10))

    angles = np.linspace(sun_angle_range[0], sun_angle_range[1], n_angles)
    bases = np.stack([EM.rotate_sh(base0, pitch=float(a)) for a in angles])
    nb = min(angle_batch, n_angles)
    psnrs = []
    for i in range(0, n_angles, nb):
        group = bases[i: i + nb]
        if len(group) < nb:
            group = np.concatenate([group, np.repeat(group[-1:], nb - len(group), 0)])
        psnrs.append(sweep_group(torch.as_tensor(group, device=dev)).cpu().numpy())
    psnrs = np.concatenate(psnrs)[:n_angles]
    best_i = int(np.argmax(psnrs))

    out = render(p, gstate, torch.as_tensor(bases[best_i], device=dev), sky_sh, cam, rcfg, bg,
                 sky, m.envlight_sh_degree, m.sky_sh_degree, m.specular, fix_sky=True,
                 debug=False, device=dev)
    image_t = torch.clamp(out.render, 0.0, 1.0)
    psnr = float(LO.mse2psnr(LO.img2mse(image_t.movedim(-1, 0), gt.movedim(-1, 0),
                                        mask=mask[None])))
    image = image_t.cpu().numpy()
    chw = np.moveaxis(image, -1, 0)
    gtc = np.moveaxis(np.asarray(view["image"], np.float32), -1, 0)
    mk = np.asarray(eval_mask, np.float32)[None]
    mae = float(np.sum(np.abs(chw - gtc) * mk) / (mk.sum() * 3 + 1e-6))
    mse = float(np.sum((chw - gtc) ** 2 * mk) / (mk.sum() * 3 + 1e-6))
    return RelightResult(image=image, best_angle=float(angles[best_i]), psnr=psnr, mae=mae,
                         mse=mse, angle_psnrs=psnrs)


@torch.no_grad()
def eval_white_light(params, gauss_state: G.GaussianState, cfg: Config, rcfg: RasterizerConfig,
                     view: dict, bg=None, device: str | torch.device = "cuda") -> np.ndarray:
    """Render under uniform white light: DC-only SH whose degree-0 irradiance is
    1, white sky. Returns [H, W, 3] in [0, 1]."""
    dev = resolve_device(device)
    m = cfg.model
    base = torch.zeros(((m.envlight_sh_degree + 1) ** 2, 3), device=dev)
    base[0] = WHITE_DC
    sky_sh = torch.zeros((1, (m.sky_sh_degree + 1) ** 2, 3), device=dev)
    bg = torch.zeros(3, device=dev) if bg is None else torch.as_tensor(bg, device=dev)
    cam, _, sky, _ = _view_on(view, dev)
    out = render(params["gaussians"], gauss_state, base, sky_sh, cam, rcfg, bg, sky,
                 m.envlight_sh_degree, m.sky_sh_degree, m.specular, fix_sky=True, debug=False,
                 device=dev)
    return torch.clamp(out.render, 0, 1).cpu().numpy()


@torch.no_grad()
def evaluate_half_metrics(renders: list[np.ndarray], gts: list[np.ndarray], lpips_fn=None,
                          device: str | torch.device = "cuda") -> dict:
    """Right-half PSNR / SSIM (/ LPIPS) of [H, W, 3] images: the novel-view
    protocol paired with left-half embedding fitting."""
    dev = resolve_device(device)
    def chw(x):
        return torch.as_tensor(np.asarray(right_half(x), np.float32), device=dev).movedim(-1, 0)

    psnrs, ssims, lpips_vals = [], [], []
    for im, gt in zip(renders, gts):
        im_r, gt_r = chw(im), chw(gt)
        psnrs.append(float(LO.psnr(im_r, gt_r)))
        ssims.append(float(LO.ssim(im_r, gt_r)))
        if lpips_fn is not None:
            lpips_vals.append(float(lpips_fn(im_r, gt_r)))
    out = {"psnr": float(np.mean(psnrs)), "ssim": float(np.mean(ssims))}
    if lpips_vals:
        out["lpips"] = float(np.mean(lpips_vals))
    return out
