"""Gauss-sharded rendering: pool rows sharded over a process group, per-Gaussian
records exchanged by tile-band owner with one all-to-all.

Port of the JAX package's `parallel/gauss_shard.py`, the distributed analog of
the reference's single-device binning for a pool that outgrows one card:

* Tile ownership: the tile grid is split into D horizontal bands of tile rows;
  rank d of the group owns band d and composites its pixels.
* Each rank preprocesses only its own shard, then for every band clamps the
  tile rects to it and packs the rows that touch it into per-Gaussian records
  (`_band_records`: mean2d, conic, opacity, colors, depth, global id and the
  band-local rect), so a Gaussian crosses the wire once per band it touches.
* One all-to-all over the group ships each bucket to its owner; its backward
  ships the records' cotangents back to their source shard.
* Each owner renders its band from the received records (`rasterize(pre=...)`).
  The received rows are ordered [source shard, ascending local index], which
  is ascending global id, and the depth sort is stable, so the entry order, and
  the image, are bitwise the single-device render's.

Static budgets with no host sync: `rows_per_band` records per (source,
destination) pair, compacted with a cumulative sum and a scatter (the shape of
JAX's `jnp.nonzero(size=cap)`); rows past the budget are dropped and counted in
the overflow, which also carries each band's binning overflow, summed over the
group. The global ids ride the records as float32, so pools of 2^24 rows or
more are refused.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..ops.preprocess import PreprocessOut, preprocess
from ..ops.rasterize import CameraMatrices, RasterizeAux, RasterizerConfig, rasterize
from . import collectives as C

MAX_POOL = 1 << 24   # global ids are exact in float32 below this
RECT_COLS = 4        # rx0, ry0, w, h


def record_width(channels: int) -> int:
    """Floats per record: mean2d(2) conic(3) op(1) colors(C) depth(1) gid(1) rect(4)."""
    return 8 + channels + RECT_COLS


def _compact(mask: torch.Tensor, cap: int):
    """The indices of mask's True rows in order, padded to `cap` with len(mask),
    and how many True rows did not fit; no host sync."""
    n = mask.shape[0]
    pos = torch.cumsum(mask.to(torch.int64), dim=0) - 1
    keep = mask & (pos < cap)
    # Rows not kept all land in the extra slot `cap`, which is cut off.
    dest = torch.where(keep, pos, cap)
    idx = torch.full((cap + 1,), n, dtype=torch.int64, device=mask.device)
    idx.scatter_(0, dest, torch.arange(n, device=mask.device))
    return idx[:cap], mask.sum() - keep.sum()


def _band_records(pre: PreprocessOut, feats: torch.Tensor, gid0: int, e: int, band_gy: int,
                  tile: int, cap: int):
    """This shard's rows that touch band e, packed into a [cap, R] record buffer;
    padding rows are zero (w = h = 0). feats: [n, 6 + C] = mean2d, conic, op,
    colors. Returns (records, dropped)."""
    n = feats.shape[0]
    y0 = e * band_gy
    rmin_y = torch.clamp(pre.rect_min[:, 1] - y0, 0, band_gy)
    rmax_y = torch.clamp(pre.rect_max[:, 1] - y0, 0, band_gy)
    h = torch.clamp_min(rmax_y - rmin_y, 0)
    w = torch.clamp_min(pre.rect_max[:, 0] - pre.rect_min[:, 0], 0)
    # Gate on the single-device tiles_touched: culled rows can carry rects that
    # would otherwise come back here.
    touched = torch.where(pre.tiles_touched > 0, h * w, 0)
    idx, dropped = _compact(touched > 0, cap)
    valid = (idx < n)[:, None]
    safe = torch.clamp_max(idx, n - 1)
    shift = torch.zeros(feats.shape[1], dtype=torch.float32, device=feats.device)
    shift[1] = float(y0 * tile)
    ints = torch.stack([pre.rect_min[:, 0], rmin_y, w, h], dim=-1).to(torch.float32)
    rec = torch.cat([feats[safe] - shift, pre.depth[safe, None],
                     (gid0 + idx)[:, None].to(torch.float32), ints[safe]], dim=-1)
    return torch.where(valid, rec, 0.0), dropped


def _records_to_pre(table: torch.Tensor, channels: int):
    """Received [M, R] records -> a band-local PreprocessOut, opacities, colors."""
    Cc = channels
    rect = table[:, 8 + Cc:].detach().to(torch.int32)
    rx0, ry0, w, h = rect.unbind(-1)
    touched = w * h
    pre = PreprocessOut(
        mean2d=table[:, 0:2],
        conic=table[:, 2:5],
        depth=table[:, 6 + Cc].detach(),
        radius=torch.where(touched > 0, 1, 0).to(torch.int32),
        tiles_touched=touched,
        rect_min=torch.stack([rx0, ry0], dim=-1),
        rect_max=torch.stack([rx0 + w, ry0 + h], dim=-1),
        cov3d=torch.zeros((table.shape[0], 6), dtype=torch.float32, device=table.device),
    )
    return pre, table[:, 5], table[:, 6:6 + Cc]


def default_rows_per_band(n_loc: int, D: int) -> int:
    """Default record budget per (source, destination) pair: ~2 n_loc / D, as if
    each row touches ~2 of the D bands, so the receive table (D * cap ~ 2 n_loc
    rows) is shard-sized, not pool-sized; at least 4096 (and at most n_loc),
    which keeps small scenes exact. Overflow stays counted."""
    return min(n_loc, max(-(-2 * n_loc // D), 4096))


def band_config(cfg: RasterizerConfig, D: int) -> RasterizerConfig:
    """A band owner's config: grid_y / D tile rows and max(max_dup / D, 4096) entries."""
    return cfg._replace(height=(cfg.grid_y // D) * cfg.tile, max_dup=max(cfg.max_dup // D, 4096))


def rasterize_gauss_shard_local(means3d, scales, quats, opacities, colors, bg,
                                cam: CameraMatrices, cfg: RasterizerConfig, group,
                                rows_per_band: int, mean2d_probe=None, active=None):
    """One rank's part of the gauss-sharded render, over `group` (size D).

    Args are this rank's pool shard ([n / D] rows) and the replicated bg and
    camera. The all-to-all runs over `group` only, so in the data x gauss
    training step each data row exchanges on its own.

    Returns (band_img [H / D, W, C], band_alpha [H / D, W], overflow (summed
    over the group), num_entries (summed), radius [n / D], depth [n / D]) with
    radius and depth from this shard's unclamped preprocess.
    """
    D = dist.get_world_size(group)
    d = dist.get_rank(group)
    n_loc = means3d.shape[0]
    band_gy = cfg.grid_y // D
    channels = colors.shape[-1]
    bcfg = band_config(cfg, D)
    dev = means3d.device
    op1 = opacities[:, 0] if opacities.ndim == 2 else opacities
    cam = CameraMatrices(*[x.to(dev) for x in cam])
    pre = preprocess(means3d, scales, quats, cam.viewmat, cam.projmat, cam.tan_fovx,
                     cam.tan_fovy, cfg.width, cfg.height, cfg.tile, cfg.scale_modifier,
                     active, op1, skip_alpha=cfg.skip_alpha)
    mean2d = pre.mean2d if mean2d_probe is None else pre.mean2d + mean2d_probe
    feats = torch.cat([mean2d, pre.conic, op1[:, None], colors], dim=-1)

    sends, drops = [], []
    for e in range(D):
        rec, dropped = _band_records(pre, feats, d * n_loc, e, band_gy, cfg.tile, rows_per_band)
        sends.append(rec)
        drops.append(dropped)
    send = torch.cat(sends, dim=0)                                    # [D * cap, R]
    # The one collective: record buckets to their tile-band owners.
    table = C.all_to_all(send, group)                                 # [D * cap, R]

    pre_b, op_b, col_b = _records_to_pre(table, channels)
    img, aux = rasterize(None, None, None, op_b, col_b, bg, cam, bcfg, device=dev, pre=pre_b)
    overflow = C.all_reduce_(torch.stack(drops).sum() + aux.overflow, group)
    num_entries = C.all_reduce_(aux.num_entries.clone(), group)
    return img, aux.alpha, overflow, num_entries, pre.radius, pre.depth


def check_pool(n_loc: int, D: int, cfg: RasterizerConfig):
    """The gauss-sharded render's shape rules: grid_y divides over D, and the
    pool of n_loc * D rows stays below 2^24."""
    if cfg.grid_y % D != 0:
        raise ValueError(f"grid_y={cfg.grid_y} must divide over {D} ranks; pad the height "
                         f"to a multiple of {cfg.tile * D}")
    if n_loc * D >= MAX_POOL:
        raise ValueError(f"pool size {n_loc * D} >= 2^24: global ids are packed as float32 "
                         f"in the record exchange; split the id into two fields first")


def rasterize_gauss_sharded(means3d, scales, quats, opacities, colors, bg,
                            cam: CameraMatrices, cfg: RasterizerConfig, group,
                            rows_per_band: int | None = None, mean2d_probe=None,
                            active=None):
    """`rasterize` with the pool sharded over `group`: every rank passes its
    shard ([n / D] rows, shard d = rows [d n / D, (d + 1) n / D)) and gets the
    full (image [H, W, C], aux). Differentiable with respect to this rank's
    means3d, scales, quats, opacities, colors and mean2d_probe: the records'
    cotangents go back through the all-to-all to their source shard, with no
    gather of the pool in either direction. The gradients are those of the sum
    of the ranks' losses (the image gather's backward sums the ranks'
    cotangents), so a loss that every rank computes alike from the full image
    is divided by D, as the gauss-sharded training step does; bg's and the
    camera's gradients are this rank's band's part.

    The image and alpha are bitwise the single-device render's; radii,
    visibility and depth are the full [n] arrays (the shards gathered);
    overflow counts the records dropped by the budget (default
    `default_rows_per_band`) plus each band's binning overflow (0 = exact).
    """
    D = dist.get_world_size(group)
    n_loc = means3d.shape[0]
    check_pool(n_loc, D, cfg)
    cap = rows_per_band or default_rows_per_band(n_loc, D)
    img_b, alpha_b, overflow, num_entries, radius, depth = rasterize_gauss_shard_local(
        means3d, scales, quats, opacities, colors, bg, cam, cfg, group, cap,
        mean2d_probe=mean2d_probe, active=active)
    radii = C.all_gather(radius, group)
    image = C.all_gather(img_b, group)[: cfg.height]
    aux = RasterizeAux(radii=radii, visibility=radii > 0, depth=C.all_gather(depth, group),
                       alpha=C.all_gather(alpha_b, group)[: cfg.height],
                       num_entries=num_entries, overflow=overflow)
    return image, aux


def render_gauss_sharded(means3d, scales, quats, opacities, colors, bg,
                         cam: CameraMatrices, cfg: RasterizerConfig, group,
                         rows_per_band: int | None = None):
    """Forward convenience wrapper: (image, alpha, overflow)."""
    img, aux = rasterize_gauss_sharded(means3d, scales, quats, opacities, colors, bg, cam, cfg,
                                       group, rows_per_band=rows_per_band)
    return img, aux.alpha, aux.overflow
