"""Headline benchmark: rasterizer fwd+bwd throughput (pixels/s) at 1M Gaussians.

Port of the JAX repo's `bench.py`. Prints ONE JSON line: {"metric", "value",
"unit", "vs_baseline", "extra"}.

    python -m relightable3dgaussians_w_torch.scripts.bench [--device=cpu]

It runs on the card unless --device=cpu is given. The scene (`build`) makes
the JAX script's numpy draws in its order, so both packages get the same bits
from a seed: n Gaussians uniform in [-2.5, 2.5]^2 x [1, 10], scales uniform
0.002-0.012 (used as activated scales: ~2-6 tiles a Gaussian at 800x800),
random unit quaternions, opacities 0.2-0.9, 3 colors, the entry module's
60-degree camera at the origin.

* train mode (default): `ops.rasterize.rasterize`, loss = image.sum() +
  alpha.sum(), `torch.autograd.grad` over means, scales, quats, opacities and
  colors. That runs kernel A (or A-int with row intervals), the sort, P, the
  gather, B at C = 3, C and D.
* render mode: the forward under `torch.inference_mode()`: A, the sort, P,
  the gather and B, or B' with BENCH_PACKED=1.

`ms_per_iter` / `ms_per_frame` is host wall time over BENCH_ITERS calls
back to back between two synchronizes; `device_ms_per_iter` /
`device_ms_per_frame` is the device time of the same calls (the profiler's
kernel sum, `utils.timing.profiled_ms`; null on the CPU), so the host's
share shows. `vs_baseline` divides by the JAX script's nominal 100 Mpix/s for
the reference CUDA rasterizer on an A100-class GPU: a nominal constant, not a
measurement. `card` is the card's nvidia-smi name and power limit.

Env knobs (JAX's names and defaults):
  BENCH_N (1,000,000), BENCH_RES (800), BENCH_ITERS (10), BENCH_MODE (train |
  render), BENCH_ANISO (1: scales[:, 0] *= it, emulating trained surfels),
  BENCH_MAX_DUP (0: the measured entry demand + 5%, rounded up to 4096, in
  [4096, 2^23]), BENCH_ROW_INTERVALS (auto: on when the interval cut is
  >= 15% and in train mode; 1 / 0 force), BENCH_SKIP_ALPHA (1/255: exact;
  larger is the serving LOD), BENCH_PACKED (0; 1 = 12-bit packed R/B, render
  mode only), BENCH_PIE (1: the stage pie and sol_pct, `stage_pie.py`),
  BENCH_PARITY (0; 1 = the card-vs-CPU parity probe, `parity.py`, train mode).

Not carried, because they have no meaning off the TPU: BENCH_PALLAS (the
kernels always run on the card, the plain versions on the CPU), BENCH_SPLIT
(a 3-dispatch split that works around XLA's schedule of the fused backward),
BENCH_CHUNK and BENCH_TILE_CHUNK (the Pallas kernels' DMA chunking and the
jnp compositor's tiles per map step) and BENCH_LMAX (the jnp compositor's
per-tile depth cap: no kernel of the port caps a tile).
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch

from .. import synthetic
from ..device import card_line, resolve_device
from ..ops.preprocess import preprocess, row_intervals
from ..ops.rasterize import RasterizerConfig, rasterize
from ..utils.timing import profiled_ms, timeit
from . import parity, stage_pie

NOMINAL_BASELINE_PIX_S = 100e6
MAX_BUDGET = 1 << 23


def entry_budget(total: int, headroom: float, cap: int | None = MAX_BUDGET) -> int:
    """The static entry budget for a measured demand: + headroom, rounded up
    to 4096, at least 4096, at most `cap` (None: no cap)."""
    budget = max(((int(total * headroom) + 4095) // 4096) * 4096, 4096)
    return budget if cap is None else min(budget, cap)


def build(n, W, H, seed=0, device="cuda", env=None):
    """(arrs = (means, scales, quats, opacities, colors), camera, RasterizerConfig)
    of the benchmark scene, on `device`; the knobs come from `env` (default
    os.environ)."""
    env = os.environ if env is None else env
    dev = resolve_device(device)
    rng = np.random.RandomState(seed)
    means = np.stack([
        rng.uniform(-2.5, 2.5, n), rng.uniform(-2.5, 2.5, n), rng.uniform(1.0, 10.0, n)
    ], -1).astype(np.float32)
    scales = rng.uniform(0.002, 0.012, (n, 3)).astype(np.float32)
    aniso = float(env.get("BENCH_ANISO", 1.0))
    if aniso != 1.0:
        scales[:, 0] *= aniso
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=1, keepdims=True)
    opac = rng.uniform(0.2, 0.9, n).astype(np.float32)
    colors = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    cam = synthetic.camera(W, H, device=dev)
    arrs = tuple(torch.as_tensor(a, device=dev) for a in (means, scales, quats, opac, colors))

    # The budget is sized from the measured entry count (+5%), as the
    # reference sizes its key buffer from the scanned duplicate count; the
    # overflow counter reports any clamp. Row intervals pay only in fwd+bwd
    # (the smaller budget feeds the sort, the gather, D and C), so `auto`
    # turns them on only in train mode and only for a cut of 15% or more.
    mode = env.get("BENCH_MODE", "train")
    max_dup = int(env.get("BENCH_MAX_DUP", 0))
    row_env = env.get("BENCH_ROW_INTERVALS", "auto")
    row_iv = row_env == "1"
    skip_alpha = float(env.get("BENCH_SKIP_ALPHA", 1.0 / 255.0))
    if max_dup == 0 or row_env == "auto":
        with torch.no_grad():
            pre = preprocess(arrs[0], arrs[1], arrs[2], cam.viewmat, cam.projmat, cam.tan_fovx,
                             cam.tan_fovy, W, H, 16, opacities=arrs[3], skip_alpha=skip_alpha)
            rect_total = int(pre.tiles_touched.sum())
            iv_total = int(row_intervals(pre, arrs[3], skip_alpha=skip_alpha)[0].sum())
        if row_env == "auto":
            cut = 1.0 - iv_total / max(rect_total, 1)
            row_iv = cut >= 0.15 and mode == "train"
        if max_dup == 0:
            max_dup = entry_budget(iv_total if row_iv else rect_total, 1.05)

    cfg = RasterizerConfig(
        width=W, height=H, max_dup=max_dup, row_intervals=row_iv, skip_alpha=skip_alpha,
        packed_rgb=env.get("BENCH_PACKED", "0") == "1" and mode == "render")
    return arrs, cam, cfg


def run(device="cuda", env=None) -> dict:
    """The benchmark's record (the JSON line's object) at the knobs of `env`
    (default os.environ)."""
    env = os.environ if env is None else env
    dev = resolve_device(device)
    n = int(env.get("BENCH_N", 1_000_000))
    W = H = int(env.get("BENCH_RES", 800))
    iters = int(env.get("BENCH_ITERS", 10))
    mode = env.get("BENCH_MODE", "train")   # train (fwd+bwd) | render (fwd)
    if mode not in ("train", "render"):
        raise ValueError(f"BENCH_MODE must be train or render, got {mode!r}")
    arrs, cam, cfg = build(n, W, H, device=dev, env=env)
    bg = torch.zeros(3, device=dev)
    card = card_line(dev)

    if mode == "render":
        def call():
            with torch.inference_mode():
                return rasterize(*arrs, bg, cam, cfg, device=dev)
    else:
        leaves = [a.detach().requires_grad_(True) for a in arrs]

        def call():
            img, aux = rasterize(*leaves, bg, cam, cfg, device=dev)
            return torch.autograd.grad(img.sum() + aux.alpha.sum(), leaves)

    # The overflow read, then a warm-up call and `iters` calls between two syncs.
    with torch.inference_mode():
        _, aux = rasterize(*arrs, bg, cam, cfg, device=dev)
        overflow = int(aux.overflow)
    dt = timeit(call, iters=iters, quiet=True)[1] / 1e3
    dev_ms = profiled_ms(call, iters) if dev.type == "cuda" else None

    unit = "frame" if mode == "render" else "iter"
    extra = {f"ms_per_{unit}": dt * 1e3, **({"fps": 1.0 / dt} if mode == "render" else {}),
             f"device_ms_per_{unit}": dev_ms, "overflow_entries": overflow,
             "backend": dev.type, "card": card, "max_dup": cfg.max_dup,
             "row_intervals": cfg.row_intervals, "skip_alpha": cfg.skip_alpha,
             "packed_rgb": cfg.packed_rgb}
    if mode == "train" and env.get("BENCH_PARITY", "0") == "1":
        extra["parity"] = parity.run(device=dev, quiet=True)
    if env.get("BENCH_PIE", "1") == "1":
        # The headline number survives a failure of the pie.
        try:
            pie = stage_pie.measure_stage_pie(arrs, cam, cfg, bg, mode=mode)
            extra["stage_pie_ms"] = pie
            extra["sol_pct"] = 100.0 * stage_pie.sol_pct(pie, dt * 1e3)
        except Exception as e:
            extra["stage_pie_error"] = f"{type(e).__name__}: {e}"[:200]
    kind = "render" if mode == "render" else "fwd_bwd"
    return {"metric": f"splat_{kind}_pixels_per_s_{n}g_{W}x{H}", "value": W * H / dt,
            "unit": "pixels/s/chip", "vs_baseline": (W * H / dt) / NOMINAL_BASELINE_PIX_S,
            "extra": extra}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    flags = dict(a.split("=", 1) for a in argv if a.startswith("--") and "=" in a)
    if set(flags) - {"--device"} or len(flags) != len(argv):
        raise SystemExit(f"usage: bench [--device=cpu] (knobs from BENCH_* env; got {argv})")
    print(json.dumps(run(flags.get("--device", "cuda"))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
