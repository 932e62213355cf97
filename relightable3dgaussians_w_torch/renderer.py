"""The render passes: port of the JAX package's `renderer.py`.

Per-Gaussian Cook-Torrance SH shading for foreground rows, sky SH color (+0.5,
clamped at 0) or fixed white for sky rows, then the rasterizer. Serving
(`render_rgb`) composites the 3 RGB channels. Training (`render`,
`render_inputs` -> `render_from_inputs`) composites every AOV as a channel of
one fused pass over the same sorted entry list; the alpha map is 1 - T_final.

Channel layout (with debug=True):
    0:3  rgb           3:6  diffuse      6:9  specular     9    depth
    10:13 normal*0.5+0.5  13:16 sky_color  16 roughness    17   metalness
    18:21 albedo
debug=False drops channels 13:21 (13 channels).

The per-Gaussian shading (`compute_colors`: the SH basis, Cook-Torrance, the
sky colour and the channels; on the card one kernel, `csrc/shade.cu`) runs
inside the `torch.profiler` range "renderer.shading", in serving and in
training alike; its gradient inside "renderer.shading_backward".
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .device import resolve_device
from .models import gaussians as G
from .ops.rasterize import rasterize, RasterizerConfig, CameraMatrices
from .ops.shading import ShadeOptions, shade_rows
from .utils.graphics import depth_to_normal


class RenderOutput(NamedTuple):
    render: torch.Tensor          # [H, W, 3]
    diffuse_color: torch.Tensor   # [H, W, 3]
    specular_color: torch.Tensor  # [H, W, 3]
    depth: torch.Tensor           # [H, W]
    normal: torch.Tensor          # [H, W, 3] in (-1, 1), sky-masked
    alpha: torch.Tensor           # [H, W]
    normal_ref: torch.Tensor      # [H, W, 3] depth-derived pseudo ground truth
    radii: torch.Tensor           # [N]
    visibility_filter: torch.Tensor  # [N] bool
    gauss_depth: torch.Tensor     # [N] view z (for the sky depth loss)
    overflow: torch.Tensor        # [] int64
    sky_color: torch.Tensor | None = None
    roughness: torch.Tensor | None = None
    metalness: torch.Tensor | None = None
    albedo: torch.Tensor | None = None


class RenderInputs(NamedTuple):
    """The rasterizer's leaf inputs, as `render_inputs` makes them from the
    parameters."""
    xyz: torch.Tensor       # [N, 3]
    scales: torch.Tensor    # [N, 3]
    quats: torch.Tensor     # [N, 4]
    opacity: torch.Tensor   # [N, 1]
    colors: torch.Tensor    # [N, C] fused AOV channels (depth channel filled)


def compute_colors(params: G.GaussianParams, state: G.GaussianState,
                   envlight_base: torch.Tensor, sky_sh: torch.Tensor,
                   envlight_sh_degree: int, sky_sh_degree: int,
                   campos: torch.Tensor, specular: bool = True, fix_sky: bool = False,
                   debug: bool = True, rgb_only: bool = True, view_row: torch.Tensor | None = None,
                   xyz: torch.Tensor | None = None, normals: bool = True):
    """Per-Gaussian feature channels (`ops/shading.py` `shade_rows`: the shading
    kernels on the card, the plain chain and its analytic gradient on the CPU).

    With rgb_only (the default here, the serving call) the shaded RGB; else the
    fused AOV channels of the module docstring (13, or 21 with debug), the
    depth channel filled from `view_row` (the view matrix's third row) where
    it is given, else left zero. `xyz`: the merged positions when the caller
    already has them (`G.get_xyz`). Returns (colors [N, 3 or C], normals
    [N, 3], or None where `normals` is False).
    """
    with torch.profiler.record_function("renderer.shading"):
        if xyz is None:
            xyz = G.get_xyz(params, state)
        opts = ShadeOptions(envlight_sh_degree, sky_sh_degree,
                            3 if rgb_only else 21 if debug else 13, specular, fix_sky, normals)
        return shade_rows(xyz, params.rotation, params.scaling, params.albedo, params.roughness,
                          params.metalness, state.is_sky, envlight_base, sky_sh, campos,
                          view_row, opts)


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
                              specular, fix_sky, xyz=xyz, normals=False)
    return rasterize(xyz, scales, quats, opacity, rgb_g, bg_color, cam, rcfg,
                     active=state.alive, device=dev)


def render_inputs(params: G.GaussianParams, state: G.GaussianState,
                  envlight_base: torch.Tensor, sky_sh: torch.Tensor,
                  cam: CameraMatrices, envlight_sh_degree: int = 4,
                  sky_sh_degree: int = 1, specular: bool = True,
                  fix_sky: bool = False, debug: bool = True) -> RenderInputs:
    """Parameters + lighting -> activated rasterizer leaf inputs, with the
    view-space depth in channel 9."""
    xyz = G.get_xyz(params, state)
    colors, _ = compute_colors(params, state, envlight_base, sky_sh, envlight_sh_degree,
                               sky_sh_degree, cam.campos, specular, fix_sky, debug,
                               rgb_only=False, view_row=cam.viewmat[2], xyz=xyz, normals=False)
    return RenderInputs(xyz, G.get_scaling(params), G.get_rotation(params),
                        G.get_opacity(params, state), colors)


def render_from_inputs(inp: RenderInputs, state: G.GaussianState, cam: CameraMatrices,
                       rcfg: RasterizerConfig, bg_color: torch.Tensor, sky_mask: torch.Tensor,
                       debug: bool = True, mean2d_probe=None,
                       device: str | torch.device = "cuda", raster_fn=None,
                       pre=None) -> RenderOutput:
    """Rasterize the prepared leaf inputs (all on `device`) and assemble the AOV
    maps.

    Args:
        bg_color: [3]; sky_mask: [H, W], 1 = not sky (masks the normal maps).
        mean2d_probe: optional [N, 2] zeros whose gradient is the pixel-space
            dL/dmean2D (for densification).
        raster_fn: optional stand-in for `rasterize` with its (xyz, scales,
            quats, opacity, colors, bg, cam, rcfg, mean2d_probe=, active=) ->
            (image, aux) contract: the tile-parallel render
            (`parallel/tile_parallel.py`) and the gauss-sharded training step
            (`parallel/data_parallel.py`) come in here.
        pre: optional precomputed `PreprocessOut` for `rasterize`.
    """
    C = inp.colors.shape[-1]
    bg = torch.cat([bg_color, bg_color, bg_color, bg_color[:1], bg_color])  # rgb diff spec depth normal
    if debug:
        bg = torch.cat([bg, bg_color, bg_color[:1], bg_color[:1], bg_color])
    if bg.shape[0] != C:
        raise ValueError(f"{C} feature channels, but the debug={debug} layout has {bg.shape[0]}")
    if raster_fn is None:
        image, aux = rasterize(
            inp.xyz, inp.scales, inp.quats, inp.opacity, inp.colors, bg, cam, rcfg,
            active=state.alive, device=device, mean2d_probe=mean2d_probe, pre=pre)
    else:
        image, aux = raster_fn(inp.xyz, inp.scales, inp.quats, inp.opacity, inp.colors, bg,
                               cam, rcfg, mean2d_probe=mean2d_probe, active=state.alive)
    alpha = aux.alpha
    depth_map = image[..., 9]
    normal_map = (image[..., 10:13] - 0.5) * 2.0
    sm = sky_mask[..., None]
    normal_map = normal_map * sm + (1.0 - sm)

    # Depth-derived reference normal, weighted by the (constant) alpha.
    c2w = torch.linalg.inv(cam.viewmat)
    normal_ref = depth_to_normal(depth_map * sky_mask, c2w, cam.tan_fovx, cam.tan_fovy)
    normal_ref = normal_ref * alpha.detach()[..., None]
    normal_ref = normal_ref + (1.0 - sm)

    return RenderOutput(
        render=image[..., 0:3],
        diffuse_color=image[..., 3:6],
        specular_color=image[..., 6:9],
        depth=depth_map,
        normal=normal_map,
        alpha=alpha,
        normal_ref=normal_ref,
        radii=aux.radii,
        visibility_filter=aux.visibility,
        gauss_depth=aux.depth,
        overflow=aux.overflow,
        sky_color=image[..., 13:16] if debug else None,
        roughness=image[..., 16] if debug else None,
        metalness=image[..., 17] if debug else None,
        albedo=image[..., 18:21] if debug else None,
    )


def render(params: G.GaussianParams, state: G.GaussianState,
           envlight_base: torch.Tensor, sky_sh: torch.Tensor,
           cam: CameraMatrices, rcfg: RasterizerConfig,
           bg_color: torch.Tensor, sky_mask: torch.Tensor,
           envlight_sh_degree: int = 4, sky_sh_degree: int = 1,
           specular: bool = True, fix_sky: bool = False, debug: bool = True,
           mean2d_probe=None, device: str | torch.device = "cuda",
           raster_fn=None) -> RenderOutput:
    """The full relightable forward pass for one camera (every AOV).

    Args:
        envlight_base: [(envlight_deg+1)**2, 3] per-image environment SH.
        sky_sh: [1, (sky_deg+1)**2, 3] sky SH.
        bg_color: [3]; sky_mask: [H, W], 1 = not sky.
        device: where to render; inputs are moved there. "cuda" (the default)
            raises when CUDA is absent.
        raster_fn: optional stand-in for `rasterize` (`render_from_inputs`).
    """
    dev = resolve_device(device)
    params = G.to_device(params, dev)
    state = G.to_device(state, dev)
    cam = CameraMatrices(*[x.to(dev) for x in cam])
    envlight_base, sky_sh, bg_color, sky_mask = (
        x.to(dev) for x in (envlight_base, sky_sh, bg_color, sky_mask))
    inp = render_inputs(params, state, envlight_base, sky_sh, cam, envlight_sh_degree,
                        sky_sh_degree, specular, fix_sky, debug)
    return render_from_inputs(inp, state, cam, rcfg, bg_color, sky_mask, debug=debug,
                              mean2d_probe=mean2d_probe, device=dev, raster_fn=raster_fn)
