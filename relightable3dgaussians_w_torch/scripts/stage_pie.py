"""Measured stage pie of the rasterizer's fwd+bwd (importable by `bench.py`).

Port of the JAX repo's `scripts/stage_pie.py`. Each stage runs on its own, 10
calls after a warm-up, on the benchmark scene's inputs. On the card a stage's
time is the device time its calls put there (`utils.timing.device_ms`: each
call queued behind a spinning kernel and timed with CUDA events, so the
card's gaps between back-to-back kernels are in it); on the CPU it is the
host clock (`utils.timing.timeit`). The stages:

* preprocess;
* binning: row intervals when on, then `bin_gaussians` (A or A-int, the
  sort, the tile ranges, P);
* gather: the entry rows through `gather_rows`, as `rasterize` builds them;
* composite_fwd: kernel B (B' with packed colors);
* train mode: composite_bwd = composite fwd+bwd - fwd (kernel C), and
  segsum_grads = gather + composite fwd+bwd - composite fwd+bwd - gather: the
  gradient's way back through the gather (kernel D's route).

The subtractions are clamped at 0. `sol_pct` is the sum of the stages over the
end-to-end time, capped at 1.

Why device time on the card: a JAX stage was one compiled program, whose time
is its device time; an eager stage here also pays a host dispatch for each of
its kernels. Timed by the host clock, an isolated call pays host time during
which the card waits, and inside the combined call part of it hides under
the card's work, so the segsum_grads subtraction came out near 0 (0.04-0.10
ms against 0.13 ms of device time, 1M Gaussians at 800x800 on an H100).
Device times subtract cleanly, and `sol_pct` then reads as the share of the
end-to-end wall time that the stages' device floors account for (the
preprocess backward is left out).
"""

from __future__ import annotations

import torch

from ..ops.binning import bin_gaussians
from ..ops.composite import pack_rb
from ..ops.cuda import tile_composite as composite_kernel
from ..ops.preprocess import preprocess, row_intervals
from ..ops.segment_sum import gather_rows
from ..utils.timing import device_ms, timeit

ITERS = 10


def measure_stage_pie(arrs, cam, cfg, bg, mode="train"):
    """{stage: ms}; arrs, cam and cfg as `bench.build` makes them."""
    means, scales, quats, opac, colors = arrs
    packed = bool(cfg.packed_rgb)
    gx, gy, tile = cfg.grid_x, cfg.grid_y, cfg.tile

    def pre_f():
        return preprocess(means, scales, quats, cam.viewmat, cam.projmat, cam.tan_fovx,
                          cam.tan_fovy, cfg.width, cfg.height, tile, cfg.scale_modifier,
                          None, opac, skip_alpha=cfg.skip_alpha)

    def bin_f(p):
        iv = (row_intervals(p, opac, tile, skip_alpha=cfg.skip_alpha) if cfg.row_intervals
              else None)
        return bin_gaussians(p, gx, gy, cfg.max_dup, iv)

    def gath_f(p, b, o, c):
        cols = [x[:, None] for x in pack_rb(c)] if packed else [c]
        feat_pack = torch.cat([p.mean2d, p.conic, o[:, None], *cols], dim=-1)
        return gather_rows(feat_pack, b.gauss_id, b.seg_bounds, b.slot_pos)

    def timed(f, *args):
        if not means.is_cuda:
            return timeit(f, *args, iters=ITERS, quiet=True)
        return f(*args), device_ms(lambda: f(*args), ITERS)

    composite = (composite_kernel.composite_forward_packed if packed
                 else composite_kernel.composite_tiles)
    with torch.no_grad():
        pre, t_pre = timed(pre_f)
        b, t_bin = timed(bin_f, pre)
        feat, t_g = timed(gath_f, pre, b, opac, colors)
        _, t_cf = timed(lambda f: composite(f, b.tile_start, b.tile_end, bg, gx, gy, tile), feat)
    pie = {"preprocess": t_pre, "binning": t_bin, "gather": t_g, "composite_fwd": t_cf}
    if mode != "train":
        return pie

    def comp_grad(f):
        f = f.detach().requires_grad_(True)
        r, tf = composite_kernel.composite_tiles(f, b.tile_start, b.tile_end, bg, gx, gy, tile)
        return torch.autograd.grad(r.sum() + tf.sum(), f)

    _, t_cfb = timed(comp_grad, feat)

    def gath_comp_grad(o, c):
        o, c = o.detach().requires_grad_(True), c.detach().requires_grad_(True)
        f = gath_f(pre, b, o, c)
        r, tf = composite_kernel.composite_tiles(f, b.tile_start, b.tile_end, bg, gx, gy, tile)
        return torch.autograd.grad(r.sum() + tf.sum(), (o, c))

    _, t_g2 = timed(gath_comp_grad, opac, colors)
    pie["composite_bwd"] = max(t_cfb - t_cf, 0.0)
    pie["segsum_grads"] = max(t_g2 - t_cfb - t_g, 0.0)
    return pie


def sol_pct(pie: dict, e2e_ms: float, preproc_vjp_ms: float | None = None):
    """Fraction of the end-to-end iteration the isolated stages account for,
    capped at 1. The preprocess backward is not isolated: unless given, it is
    left out of the sum, so the fraction is conservative."""
    floor = sum(pie.values()) + (preproc_vjp_ms or 0.0)
    return min(floor / max(e2e_ms, 1e-9), 1.0)
