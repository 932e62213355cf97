"""Tile-parallel rendering: one image's tile rows split into bands over devices.

Port of the JAX package's `parallel/tile_parallel.py`. After preprocessing,
every tile's entry list is self-contained, so a horizontal band of tile rows
can bin and composite on its own device with no communication but gathering
the bands and summing the counters. The preprocess runs once, on the inputs'
device; each band gets the rects clamped to its rows and the centers shifted
into band coordinates (`_band_pre`), then `rasterize(pre=...)` on its device.
The bands concatenate along H into exactly the single-device image: the
preprocess is the same computation and each tile's entry list, in its depth
order, is unchanged, so this is a bitwise-equal decomposition.

It needs no process group: one process drives a list of devices (several
cards, or one card more than once), as JAX's render CLI drives a mesh from one
process.
"""

from __future__ import annotations

import torch

from ..ops.preprocess import PreprocessOut, preprocess
from ..ops.rasterize import CameraMatrices, RasterizeAux, RasterizerConfig, rasterize


def _band_pre(pre: PreprocessOut, y0: int, band_gy: int, tile: int) -> PreprocessOut:
    """Clamp the tile rects to the band of tile rows [y0, y0 + band_gy) and shift
    the pixel-space centers into band coordinates. Rows whose rect misses the
    band get tiles_touched = 0, as culled rows do."""
    rmin_y = torch.clamp(pre.rect_min[:, 1] - y0, 0, band_gy)
    rmax_y = torch.clamp(pre.rect_max[:, 1] - y0, 0, band_gy)
    h = torch.clamp_min(rmax_y - rmin_y, 0)
    w = torch.clamp_min(pre.rect_max[:, 0] - pre.rect_min[:, 0], 0)
    # Gate on the original tiles_touched: culled rows can carry rects that a
    # bare h * w would bring back inside the band.
    touched = torch.where(pre.tiles_touched > 0, h * w, 0)
    shift = torch.tensor([0.0, float(y0 * tile)], dtype=torch.float32, device=pre.mean2d.device)
    return pre._replace(
        mean2d=pre.mean2d - shift,
        rect_min=torch.stack([pre.rect_min[:, 0], rmin_y], dim=-1),
        rect_max=torch.stack([pre.rect_max[:, 0], rmax_y], dim=-1),
        tiles_touched=touched.to(pre.tiles_touched.dtype),
        radius=torch.where(touched > 0, pre.radius, 0),
    )


def band_config(cfg: RasterizerConfig, n: int) -> RasterizerConfig:
    """One band's config: grid_y / n tile rows and max(max_dup / n, 16384) entries."""
    return cfg._replace(height=(cfg.grid_y // n) * cfg.tile, max_dup=max(cfg.max_dup // n, 4096 * 4))


def rasterize_tile_sharded(means3d, scales, quats, opacities, colors, bg,
                           cam: CameraMatrices, cfg: RasterizerConfig, devices,
                           mean2d_probe=None, active=None):
    """`rasterize` with the image's tile rows split over `devices` (one band
    each, in order; a device may repeat). Same (image, RasterizeAux) contract,
    so it drops into `render_from_inputs(raster_fn=...)`. grid_y must divide by
    len(devices) (pad the height to a multiple of tile * len(devices)). The
    image, alpha, radii and depth are bitwise the single-device `rasterize`'s;
    num_entries and overflow are the bands' sums. Gradients flow to every
    input; the result lies on devices[0]."""
    n = len(devices)
    gy = cfg.grid_y
    if gy % n != 0:
        raise ValueError(f"grid_y={gy} must divide over {n} devices; pad the height "
                         f"to a multiple of {cfg.tile * n}")
    band_gy = gy // n
    bcfg = band_config(cfg, n)
    dev = means3d.device
    op1 = opacities[:, 0] if opacities.ndim == 2 else opacities
    cam = CameraMatrices(*[x.to(dev) for x in cam])
    pre = preprocess(means3d, scales, quats, cam.viewmat, cam.projmat, cam.tan_fovx,
                     cam.tan_fovy, cfg.width, cfg.height, cfg.tile, cfg.scale_modifier,
                     active, op1, skip_alpha=cfg.skip_alpha)
    if mean2d_probe is not None:
        pre = pre._replace(mean2d=pre.mean2d + mean2d_probe)
    imgs, alphas, entries, overflow = [], [], [], []
    for k, band_dev in enumerate(devices):
        band_dev = torch.device(band_dev)
        band = _band_pre(pre, k * band_gy, band_gy, cfg.tile)
        img, aux = rasterize(None, None, None, op1, colors, bg, cam, bcfg, device=band_dev,
                             pre=band)
        out = torch.device(devices[0])
        imgs.append(img.to(out))
        alphas.append(aux.alpha.to(out))
        entries.append(aux.num_entries.to(out))
        overflow.append(aux.overflow.to(out))
    out = torch.device(devices[0])
    radii = pre.radius.to(out)
    aux = RasterizeAux(radii=radii, visibility=radii > 0, depth=pre.depth.to(out),
                       alpha=torch.cat(alphas, dim=0)[: cfg.height],
                       num_entries=torch.stack(entries).sum(),
                       overflow=torch.stack(overflow).sum())
    return torch.cat(imgs, dim=0)[: cfg.height], aux


def make_tile_parallel_raster_fn(devices):
    """A raster_fn for `render_from_inputs`: tile-parallel rendering over `devices`."""
    devices = list(devices)

    def raster_fn(xyz, scales, quats, opacity, colors, bg, cam, rcfg, mean2d_probe=None,
                  active=None):
        return rasterize_tile_sharded(xyz, scales, quats, opacity, colors, bg, cam, rcfg,
                                      devices, mean2d_probe=mean2d_probe, active=active)
    return raster_fn


def render_tile_sharded(means3d, scales, quats, opacities, colors, bg,
                        cam: CameraMatrices, cfg: RasterizerConfig, devices):
    """Forward convenience wrapper: (image [H, W, C], alpha [H, W])."""
    img, aux = rasterize_tile_sharded(means3d, scales, quats, opacities, colors, bg, cam, cfg,
                                      devices)
    return img, aux.alpha
