"""Differentiable Gaussian rasterizer: preprocess -> bin -> gather -> composite.

Port of the JAX package's `ops/rasterize.py` (`RasterizerConfig`,
`CameraMatrices`, `RasterizeAux`, `_assemble_image`, `rasterize_aux`,
`rasterize`). On the card
the expansion, the compositor (forward and backward) and the gather's transpose
are the hand-written CUDA kernels of `ops/cuda/`; on the CPU their plain
PyTorch versions. Gradients flow with autograd: through preprocess to means,
scales and quaternions, and through the gather (`ops/segment_sum.gather_rows`)
and the compositor (`ops/cuda/tile_composite.composite_tiles`) to opacities,
colors, bg and the optional `mean2d_probe`. With `packed_rgb` (serving only)
the colors go through the gather as 12-bit packed R|B plus exact G and the
forward-only kernel B' composites them; a render that needs gradients raises.
The TPU layout knobs of the JAX config (Pallas chunking, segment alignment,
tiles per grid step) have no meaning here and are dropped. Each stage runs inside a `torch.profiler` range
("rasterize.preprocess", ".binning", ".gather", ".composite"), so a profile
of any caller splits its time by stage; inside ".binning", "binning.sort"
holds the depth argsort, the expansion and the key sort (`ops/binning.py`).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..device import resolve_device
from .binning import BinningOut, bin_gaussians
from .composite import pack_rb
from .cuda import tile_composite as _composite_kernel
from .preprocess import PreprocessOut, preprocess, row_intervals
from .segment_sum import gather_rows


class RasterizerConfig(NamedTuple):
    """Static rasterizer configuration."""
    width: int
    height: int
    tile: int = 16
    max_dup: int = 1 << 18           # total (Gaussian, tile) entry budget
    scale_modifier: float = 1.0
    row_intervals: bool = False      # exact per-tile-row ellipse intervals in
                                     # binning: drops (Gaussian, tile) pairs
                                     # outside the alpha >= 1/255 ellipse; the
                                     # image and gradients do not change
    skip_alpha: float = 1.0 / 255.0  # rect tightening threshold; 1/255 = exact,
                                     # larger = serving LOD (fewer entries, each
                                     # dropped one < skip_alpha per pixel)
    packed_rgb: bool = False         # serving only (3 channels, no gradient):
                                     # R and B quantized to 12 bits in one
                                     # entry column, G exact; per-channel
                                     # error <= 8/4095/2 ~ 9.8e-4

    @property
    def grid_x(self) -> int:
        return (self.width + self.tile - 1) // self.tile

    @property
    def grid_y(self) -> int:
        return (self.height + self.tile - 1) // self.tile


class CameraMatrices(NamedTuple):
    """Camera inputs (math convention: apply as M @ [p, 1])."""
    viewmat: torch.Tensor   # [4, 4] world -> view
    projmat: torch.Tensor   # [4, 4] full projection = P @ viewmat
    campos: torch.Tensor    # [3]
    tan_fovx: torch.Tensor  # [] float32
    tan_fovy: torch.Tensor  # [] float32


class RasterizeAux(NamedTuple):
    radii: torch.Tensor        # [N] int32 screen radius (0 = culled)
    visibility: torch.Tensor   # [N] bool (radii > 0)
    depth: torch.Tensor        # [N] view-space z per Gaussian
    alpha: torch.Tensor        # [H, W] 1 - T_final
    num_entries: torch.Tensor  # [] int64
    overflow: torch.Tensor     # [] int64 dropped entries (0 = exact render)


def _assemble_image(tiles_rgb, tiles_tfin, cfg: RasterizerConfig, channels: int):
    gx, gy, t = cfg.grid_x, cfg.grid_y, cfg.tile
    img = tiles_rgb.reshape(gy, gx, t, t, channels)
    img = img.permute(0, 2, 1, 3, 4).reshape(gy * t, gx * t, channels)
    tfin = tiles_tfin.reshape(gy, gx, t, t).permute(0, 2, 1, 3).reshape(gy * t, gx * t)
    return img[: cfg.height, : cfg.width], tfin[: cfg.height, : cfg.width]


def _preprocess(means3d, scales, quats, opacities, cam: CameraMatrices, cfg: RasterizerConfig,
                active, cov3d_precomp, dev: torch.device) -> PreprocessOut:
    """The preprocess stage of `rasterize` on `dev` (opacities None: the
    untightened rects)."""
    to_dev = lambda x: None if x is None else x.to(dev, torch.float32)
    means3d, scales, quats, cov3d_precomp = map(to_dev, (means3d, scales, quats, cov3d_precomp))
    cam = CameraMatrices(*[x.to(dev) for x in cam])
    if active is not None:
        active = active.to(dev)
    with torch.profiler.record_function("rasterize.preprocess"):
        return preprocess(means3d, scales, quats, cam.viewmat, cam.projmat, cam.tan_fovx,
                          cam.tan_fovy, cfg.width, cfg.height, cfg.tile, cfg.scale_modifier,
                          active, opacities, skip_alpha=cfg.skip_alpha,
                          cov3d_precomp=cov3d_precomp)


def rasterize_aux(means3d, scales, quats, cam: CameraMatrices, cfg: RasterizerConfig,
                  cov3d_precomp=None, active=None,
                  device: str | torch.device = "cuda") -> tuple[PreprocessOut, BinningOut]:
    """Preprocess and binning only, no compositing: visibility and tile
    entries, the reference's `markVisible` (rasterize_points.cu:194-213). As
    in the JAX function the rects are the untightened ones (no opacities) and
    the binning walks them, whatever `cfg.row_intervals` says: kernels A and P
    on the card."""
    dev = resolve_device(device)
    pre = _preprocess(means3d, scales, quats, None, cam, cfg, active, cov3d_precomp, dev)
    with torch.profiler.record_function("rasterize.binning"):
        return pre, bin_gaussians(pre, cfg.grid_x, cfg.grid_y, cfg.max_dup)


def rasterize(means3d, scales, quats, opacities, colors, bg,
              cam: CameraMatrices, cfg: RasterizerConfig, active=None,
              device: str | torch.device = "cuda", mean2d_probe=None,
              pre: PreprocessOut | None = None):
    """Render depth-sorted alpha-composited Gaussians.

    Args:
        means3d: [N, 3] world positions.
        scales: [N, 3] activated scales.
        quats: [N, 4] normalized quaternions (w, x, y, z).
        opacities: [N] or [N, 1] activated opacities in (0, 1).
        colors: [N, C] per-Gaussian features to composite.
        bg: [C] background value per channel.
        active: optional [N] bool; False rows are culled.
        device: where to render; inputs are moved there. "cuda" (the default)
            raises when CUDA is absent.
        mean2d_probe: optional [N, 2] zeros added to the projected centers
            before the gather; its gradient is the pixel-space dL/dmean2D
            (multiply by (0.5 W, 0.5 H) for the reference's NDC units).
        pre: optional precomputed PreprocessOut, used in place of the
            preprocess of means3d, scales and quats (which may then be None):
            the tile-parallel and gauss-sharded renders pass band-clamped
            rects and band-local centers (`parallel/`). Gradients flow
            through its mean2d and conic.

    Returns:
        image: [H, W, C]
        aux: RasterizeAux
    """
    if cfg.packed_rgb:
        if colors.shape[-1] != 3:
            raise ValueError(f"packed_rgb composites 3 color channels, got {colors.shape[-1]}")
        if torch.is_grad_enabled() and any(
                x is not None and x.requires_grad
                for x in (means3d, scales, quats, opacities, colors, bg, mean2d_probe)):
            raise ValueError("packed_rgb is a forward-only serving mode: render with "
                             "packed_rgb=False to differentiate")
    dev = resolve_device(device)
    opacities, colors, bg = (x.to(dev, torch.float32) for x in (opacities, colors, bg))
    if opacities.ndim == 2:
        opacities = opacities[:, 0]

    stage = torch.profiler.record_function
    if pre is None:
        pre = _preprocess(means3d, scales, quats, opacities, cam, cfg, active, None, dev)
    else:
        pre = PreprocessOut(*[x.to(dev) for x in pre])
    with stage("rasterize.binning"):
        intervals = (row_intervals(pre, opacities, cfg.tile, skip_alpha=cfg.skip_alpha)
                     if cfg.row_intervals else None)
        binning = bin_gaussians(pre, cfg.grid_x, cfg.grid_y, cfg.max_dup, intervals)
    with stage("rasterize.gather"):
        mean2d = pre.mean2d if mean2d_probe is None else pre.mean2d + mean2d_probe.to(dev)
        # Entry rows in sorted order: mean2d, conic, opacity, colors (packed:
        # R|B, G). Slots past the real entries carry id 0 and lie outside every
        # tile range and every Gaussian's slot run: no gradient.
        color_cols = [c[:, None] for c in pack_rb(colors)] if cfg.packed_rgb else [colors]
        feat_pack = torch.cat([mean2d, pre.conic, opacities[:, None], *color_cols], dim=-1)
        feat = gather_rows(feat_pack, binning.gauss_id, binning.seg_bounds, binning.slot_pos)
    with stage("rasterize.composite"):
        if cfg.packed_rgb:
            tiles_rgb, tiles_tfin = _composite_kernel.composite_forward_packed(
                feat, binning.tile_start, binning.tile_end, bg, cfg.grid_x, cfg.grid_y,
                cfg.tile)
        else:
            tiles_rgb, tiles_tfin = _composite_kernel.composite_tiles(
                feat, binning.tile_start, binning.tile_end, bg, cfg.grid_x, cfg.grid_y,
                cfg.tile)
        image, tfin = _assemble_image(tiles_rgb, tiles_tfin, cfg, colors.shape[-1])
    aux = RasterizeAux(
        radii=pre.radius,
        visibility=pre.radius > 0,
        depth=pre.depth,
        alpha=1.0 - tfin,
        num_entries=binning.num_entries,
        overflow=binning.overflow,
    )
    return image, aux
