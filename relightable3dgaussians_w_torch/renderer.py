"""The serving render pass: port of the JAX package's `renderer.py`
`compute_colors` (its `rgb_only=True` branch) and `render_rgb`.

Per-Gaussian Cook-Torrance SH shading for foreground rows, sky SH color (+0.5,
clamped at 0) or fixed white for sky rows, then the 3-channel rasterizer. The
fused 13-21 channel AOV render is a training construct and arrives with the
training slice.
"""

from __future__ import annotations

import torch

from .device import resolve_device
from .models import gaussians as G
from .models import light as L
from .ops.rasterize import rasterize, RasterizerConfig, CameraMatrices
from .utils.sh import eval_sh


def compute_colors(params: G.GaussianParams, state: G.GaussianState,
                   envlight_base: torch.Tensor, sky_sh: torch.Tensor,
                   envlight_sh_degree: int, sky_sh_degree: int,
                   campos: torch.Tensor, specular: bool = True, fix_sky: bool = False):
    """Per-Gaussian shaded RGB (the JAX `compute_colors(..., rgb_only=True)`).

    Returns (rgb [N, 3], normals [N, 3]).
    """
    xyz = G.get_xyz(params, state)
    albedo = G.get_albedo(params)
    kr = G.get_roughness(params)
    km = G.get_metalness(params)
    is_sky = state.is_sky[:, None]

    dir_pp = xyz - campos[None, :]
    dir_pp_n = L.safe_normalize(dir_pp)
    normal = G.get_normal(params, dir_pp_n)

    shaded = L.shade(envlight_base, envlight_sh_degree, xyz, normal, albedo, campos,
                     kr, km, specular=specular)

    if fix_sky:
        sky_rgb = torch.ones_like(xyz)
    else:
        sky_sh2rgb = eval_sh(sky_sh_degree, sky_sh.transpose(-1, -2), dir_pp_n)
        sky_rgb = torch.clamp_min(sky_sh2rgb + 0.5, 0.0)

    return torch.where(is_sky, sky_rgb, shaded.rgb), normal


def render_rgb(params: G.GaussianParams, state: G.GaussianState,
               envlight_base: torch.Tensor, sky_sh: torch.Tensor,
               cam: CameraMatrices, rcfg: RasterizerConfig,
               bg_color: torch.Tensor, envlight_sh_degree: int = 4,
               sky_sh_degree: int = 1, specular: bool = True,
               fix_sky: bool = False, device: str | torch.device = "cuda"):
    """Serving fast path: composite only the 3 RGB channels.

    Args:
        envlight_base: [(envlight_deg+1)**2, 3] per-image environment SH.
        sky_sh: [1, (sky_deg+1)**2, 3] sky SH.
        device: where to render; inputs are moved there. "cuda" (the default)
            raises when CUDA is absent.
    Returns:
        (rgb [H, W, 3], aux: RasterizeAux). `aux.alpha` is the JAX version's
        second output; `aux.overflow` says whether the entry budget held.
    """
    dev = resolve_device(device)
    params = G.to_device(params, dev)
    state = G.to_device(state, dev)
    cam = CameraMatrices(*[x.to(dev) for x in cam])
    envlight_base, sky_sh, bg_color = (x.to(dev) for x in (envlight_base, sky_sh, bg_color))

    xyz = G.get_xyz(params, state)
    scales = G.get_scaling(params)
    quats = G.get_rotation(params)
    opacity = G.get_opacity(params, state)
    rgb_g, _ = compute_colors(params, state, envlight_base, sky_sh,
                              envlight_sh_degree, sky_sh_degree, cam.campos,
                              specular, fix_sky)
    return rasterize(xyz, scales, quats, opacity, rgb_g, bg_color, cam, rcfg,
                     active=state.alive, device=dev)
