"""Training losses: port of the JAX package's `utils/losses.py`.

Masked L1 and L2, masked SSIM (11x11 sigma-1.5 Gaussian window), the
environment-light R+ constraint and hemisphere negativity penalty, the planar
min-scale prior, the sky/foreground Gaussian and depth-map separations, the
depth smoothness term, the {0, 1} push, MAE and PSNR. Data-dependent branches
stay masked reductions with safe denominators, as in the JAX package, so
nothing syncs with the host.

Random draws come in as tensors: `envl_sh_loss` takes its sample directions
from the caller (the training step's `StepDraws`); `envlight_loss` takes its
normal subset and hemisphere draws, or a `torch.Generator` to draw them.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from .general import rand_hemisphere_dir
from .sh import eval_sh

TINY_NUMBER = 1e-6


def _masked_mean(x: torch.Tensor, mask: torch.Tensor | None) -> torch.Tensor:
    if mask is None:
        return torch.mean(x)
    num = torch.sum(mask == 1)
    return torch.where(num > 0, torch.sum(x * mask) / torch.clamp_min(num, 1), 0.0)


def l1_loss(pred: torch.Tensor, gt: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean |pred - gt|; with a {0, 1} mask, the sum over masked pixels over their
    count."""
    return _masked_mean(torch.abs(pred - gt), mask)


def l2_loss(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    return torch.mean((pred - gt) ** 2)


def gaussian_window_1d(window_size: int = 11, sigma: float = 1.5) -> np.ndarray:
    xs = np.arange(window_size)
    g = np.exp(-((xs - window_size // 2) ** 2) / (2 * sigma**2))
    return (g / g.sum()).astype(np.float32)


def _blur(img: torch.Tensor, win: np.ndarray, window_size: int) -> torch.Tensor:
    """Separable 11x11 Gaussian blur of [C, H, W] with 'same' zero padding, as
    shifted adds: every product and sum is an elementwise float32 operation, so
    SSIM's variance terms (E[x^2] - mu^2, a cancellation) keep full precision and
    no TF32 convolution can reach them."""
    pad = window_size // 2

    def pass_along(x, dim):
        padw = [0, 0, 0, 0]
        padw[(2 - dim) * 2:(2 - dim) * 2 + 2] = [pad, pad]   # F.pad lists the last dim first
        xp = F.pad(x, padw)
        n = x.shape[dim]
        acc = None
        for k in range(window_size):
            term = float(win[k]) * xp.narrow(dim, k, n)
            acc = term if acc is None else acc + term
        return acc

    return pass_along(pass_along(img, 1), 2)


def ssim(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11,
         mask: torch.Tensor | None = None) -> torch.Tensor:
    """SSIM of [C, H, W] images with an 11x11 sigma-1.5 window and zero-padded
    borders, optionally averaged over a {0, 1} mask broadcastable to [C, H, W]."""
    win = gaussian_window_1d(window_size)
    mu1 = _blur(img1, win, window_size)
    mu2 = _blur(img2, win, window_size)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = _blur(img1 * img1, win, window_size) - mu1_sq
    sigma2_sq = _blur(img2 * img2, win, window_size) - mu2_sq
    sigma12 = _blur(img1 * img2, win, window_size) - mu1_mu2
    C1, C2 = 0.01**2, 0.03**2
    ssim_map = ((2 * mu1_mu2 + C1) * (2 * sigma12 + C2)) / (
        (mu1_sq + mu2_sq + C1) * (sigma1_sq + sigma2_sq + C2))
    if mask is None:
        return torch.mean(ssim_map)
    mask = torch.broadcast_to(mask, ssim_map.shape)
    num = torch.sum(mask == 1)
    return torch.where(num > 0, torch.sum(ssim_map * mask) / torch.clamp_min(num, 1), 1.0)


def zero_one_loss(img: torch.Tensor) -> torch.Tensor:
    """Push values toward {0, 1}: mean of log(v) + log(1 - v), v clipped to
    [1e-3, 1 - 1e-3]."""
    eps = 1e-3
    val = torch.clamp(img, eps, 1 - eps)
    return torch.mean(torch.log(val) + torch.log(1 - val))


def _box_blur5(x: torch.Tensor) -> torch.Tensor:
    """5x5 mean of [H, W] with zero padding, as 25 shifted float32 products
    summed in the kernel's row-major order: no convolution, so no TF32 path
    can reach it (the JAX package pins its convolution to HIGHEST)."""
    H, W = x.shape
    xp = F.pad(x, [2, 2, 2, 2])
    acc = None
    for i in range(5):
        for j in range(5):
            term = xp[i:i + H, j:j + W] * (1.0 / 25.0)
            acc = term if acc is None else acc + term
    return acc


def smoothing_depth_loss(depth_map: torch.Tensor, mask: torch.Tensor | None = None
                         ) -> torch.Tensor:
    """L1 distance between the depth map [H, W] and its 5x5 box blur, which is
    held constant (no gradient); with a {0, 1} mask, over the masked pixels."""
    avg = _box_blur5(depth_map).detach()
    if mask is None:
        return torch.mean(torch.abs(depth_map - avg))
    num = torch.sum(mask == 1)
    return torch.where(num > 0, torch.sum(torch.abs(depth_map * mask - avg * mask))
                       / torch.clamp_min(num, 1), 0.0)


def sky_depth_loss(depth_map: torch.Tensor, sky_mask: torch.Tensor,
                   gamma: float = 0.02) -> torch.Tensor:
    """exp(-gamma * (mean sky depth - mean non-sky depth)) over the depth map
    [H, W]; sky_mask [H, W] is 1 where NOT sky, as the reference's. The non-sky
    mean is held constant (no gradient); 0 when no pixel is sky."""
    nosky = 1.0 - sky_mask
    n_sky = torch.sum(nosky == 1)
    n_nosky = torch.sum(sky_mask == 1)
    mean_nosky = (torch.sum(depth_map * sky_mask) / torch.clamp_min(n_nosky, 1)).detach()
    mean_sky = torch.sum(depth_map * nosky) / torch.clamp_min(n_sky, 1)
    loss = torch.exp(-gamma * (mean_sky - mean_nosky))
    return torch.where(n_sky > 0, loss, 0.0)


def envlight_loss(draws, envlight_sh: torch.Tensor, sh_degree: int, normals: torch.Tensor,
                  n_dirs: int = 1000, normals_subset_size: int = 100) -> torch.Tensor:
    """Negativity penalty on the SH environment light: cosine-weighted
    directions around a subset of the normals, the light's negative part
    averaged, squared.

    Args:
        draws: (idx, rand): the subset's row indices [take] (distinct) and the
            uniform [0, 1) draws [take, n_dirs, 3] of `rand_hemisphere_dir`;
            or a `torch.Generator` that draws both (on its device), with
            take = min(normals_subset_size, N).
        envlight_sh: [(deg+1)**2, 3] SH coefficients.
        normals: [N, 3].
    """
    if isinstance(draws, torch.Generator):
        take = min(normals_subset_size, normals.shape[0])
        idx = torch.randperm(normals.shape[0], generator=draws, device=draws.device)[:take]
        rand = torch.rand((take, n_dirs, 3), generator=draws, device=draws.device)
    else:
        idx, rand = draws
    dirs = rand_hemisphere_dir(rand.to(normals.device), n_dirs,
                               normals[idx.to(normals.device)])   # [take, n_dirs, 3]
    light = eval_sh(sh_degree, envlight_sh.transpose(0, 1), dirs)  # [take, n_dirs, 3]
    light = torch.clamp_max(light, 0.0)
    avg = torch.mean(torch.mean(light, dim=1), dim=0)
    return torch.mean(avg**2)


def penalize_outside_range(x: torch.Tensor, lower: float = 0.0, upper: float = 1.0) -> torch.Tensor:
    """Mean squared violation below `lower` plus mean squared violation above
    `upper`, each over its own violating count."""
    below = torch.clamp_max(x - lower, 0.0)
    above = torch.clamp_min(x - upper, 0.0) if math.isfinite(upper) else torch.zeros_like(x)
    n_below = torch.sum(below < 0)
    n_above = torch.sum(above > 0)
    e_below = torch.where(n_below > 0, torch.sum(below**2) / torch.clamp_min(n_below, 1), 0.0)
    e_above = torch.where(n_above > 0, torch.sum(above**2) / torch.clamp_min(n_above, 1), 0.0)
    return e_below + e_above


def envl_sh_loss(dirs: torch.Tensor, sh_env: torch.Tensor, sh_degree: int) -> torch.Tensor:
    """R+ constraint: the environment SH evaluated at sample directions must not
    be negative.

    Args:
        dirs: [n, 3] samples uniform in [-1, 1]^3 (normalized here).
        sh_env: [(deg+1)**2, 3].
    """
    v = dirs / (torch.linalg.vector_norm(dirs, dim=1, keepdim=True) + 1e-12)
    vals = eval_sh(sh_degree, sh_env.transpose(0, 1)[None], v)  # [n, 3]
    return penalize_outside_range(vals.reshape(-1), 0.0, math.inf)


def _pool_sum(x: torch.Tensor, pool_group) -> torch.Tensor:
    """x summed over the ranks of `pool_group` (differentiable), or x."""
    if pool_group is None:
        return x
    from ..parallel import collectives

    if x.requires_grad:
        return collectives.all_reduce(x, pool_group)
    return collectives.all_reduce_(x.clone(), pool_group)


def min_scale_loss(scaling: torch.Tensor, radii: torch.Tensor, is_sky: torch.Tensor,
                   pool_group=None) -> torch.Tensor:
    """Mean of the smallest scale over visible foreground Gaussians (the planar
    prior).

    pool_group: the process group the pool rows are sharded over, if they are;
    the masked mean's numerator and count are then summed over its ranks before
    the division, so every rank returns the global value."""
    m = (radii > 0) & (~is_sky)
    min_s = torch.amin(scaling, dim=-1)
    n = _pool_sum(torch.sum(m), pool_group)
    num = _pool_sum(torch.sum(torch.where(m, min_s, 0.0)), pool_group)
    return torch.where(n > 0, num / torch.clamp_min(n, 1), 0.0)


def depth_loss_gaussians(depths: torch.Tensor, is_sky: torch.Tensor, visible: torch.Tensor,
                         gamma: float = 0.02, pool_group=None) -> torch.Tensor:
    """exp(-gamma * (mean depth of visible sky Gaussians - mean depth of visible
    foreground Gaussians)); the foreground mean is held constant (no gradient).

    pool_group: as in `min_scale_loss`; the four sums are summed over its ranks
    before the exp."""
    sky_m = is_sky & visible
    fg_m = (~is_sky) & visible
    n_sky = _pool_sum(torch.sum(sky_m), pool_group)
    n_fg = _pool_sum(torch.sum(fg_m), pool_group)
    s_sky = _pool_sum(torch.sum(torch.where(sky_m, depths, 0.0)), pool_group)
    s_fg = _pool_sum(torch.sum(torch.where(fg_m, depths, 0.0)).detach(), pool_group)
    avg_sky = s_sky / torch.clamp_min(n_sky, 1)
    avg_fg = (s_fg / torch.clamp_min(n_fg, 1)).detach()
    loss = torch.exp(-gamma * (avg_sky - avg_fg))
    return torch.where((n_sky > 0) & (n_fg > 0), loss, 0.0)


def img2mse(x: torch.Tensor, y: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
    if mask is None:
        return torch.mean((x - y) ** 2)
    mask = torch.broadcast_to(mask, x.shape)
    return torch.sum((x - y) ** 2 * mask) / (torch.sum(mask) + TINY_NUMBER)


def img2mae(x: torch.Tensor, y: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
    if mask is None:
        return torch.mean(torch.abs(x - y))
    mask = torch.broadcast_to(mask, x.shape)
    return torch.sum(torch.abs(x - y) * mask) / (torch.sum(mask) + TINY_NUMBER)


def mse2psnr(x) -> torch.Tensor:
    return -10.0 * torch.log(x + TINY_NUMBER) / math.log(10.0)


def psnr(img1: torch.Tensor, img2: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
    return mse2psnr(img2mse(img1, img2, mask))
