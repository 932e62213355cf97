"""Full training-iteration timing: `train_step.train_step` (render, shading,
loss stack, autograd, Adam) on a synthetic pool.

Port of the JAX repo's `scripts/bench_train_step.py`, the counterpart of the
reference's `iter_time` scalar. The draws are the JAX script's: n points
uniform in [-2.5, 2.5]^2 x [1, 10] with knn_dist2 5e-5 (initial scales ~0.007,
the bench scene's ~2-6 tiles a Gaussian), the pool rounded up to 4096 rows,
the entry budget the measured demand x 1.3 (rounded up to 4096, in [4096,
2^23]); a random ground truth and sky mask, no occluders, black background.
The MLP (the config's SH degrees, 256/256/128) and 8 embeddings come from a
seeded torch.Generator, each step's draws (`train_step.make_draws`) from
another.

    python -m relightable3dgaussians_w_torch.scripts.bench_train_step \\
        [n=500000] [res=800] [iters=10] [--device=cpu]

Env TRAIN_BENCH_N / TRAIN_BENCH_RES / TRAIN_BENCH_ITERS set the defaults. It
runs on the card unless --device=cpu is given. One warm-up step, then `iters`
steps from the same starting state back to back between two synchronizes
(host wall time). Prints the JAX script's lines, then one JSON line with
ms_per_iter, its_per_s, the warm-up step's loss, the largest entry overflow
of every step and the card's nvidia-smi name and power limit. JAX's
TRAIN_SPLIT and TRAIN_BENCH_CHUNK (the TPU step's dispatch split and the
Pallas kernels' chunking) have no counterpart.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
import torch

from .. import synthetic, train_step as TS
from ..config import Config
from ..device import card_line, resolve_device
from ..models import gaussians as G
from ..models.nets import MLPNet
from ..ops.preprocess import preprocess
from ..ops.rasterize import RasterizerConfig
from ..utils.timing import sync
from .bench import entry_budget


def main(n=500_000, res=800, iters=10, device="cuda"):
    """Time the step; prints its lines and returns ms per step."""
    dev = resolve_device(device)
    rng = np.random.RandomState(0)
    cam = synthetic.camera(res, res, device=dev)

    pts = np.stack([rng.uniform(-2.5, 2.5, n), rng.uniform(-2.5, 2.5, n),
                    rng.uniform(1.0, 10.0, n)], -1).astype(np.float32)
    capacity = ((n + 4095) // 4096) * 4096
    params_g, gstate = G.init_from_points(pts, np.full(n, 5e-5, np.float32), capacity,
                                          device=dev)

    with torch.no_grad():
        total = int(preprocess(params_g.xyz, torch.exp(params_g.scaling), params_g.rotation,
                               cam.viewmat, cam.projmat, cam.tan_fovx, cam.tan_fovy, res, res,
                               16, opacities=torch.sigmoid(params_g.opacity)
                               ).tiles_touched.sum())
    max_dup = entry_budget(total, 1.3)
    print(f"n={n} res={res} entries~{total} max_dup={max_dup}", flush=True)

    rcfg = RasterizerConfig(width=res, height=res, max_dup=max_dup)
    cfg = Config()
    m = cfg.model
    gen = torch.Generator().manual_seed(0)
    mlp = MLPNet(m.envlight_sh_degree, m.sky_sh_degree, m.embeddings_dim, generator=gen).to(dev)
    emb = torch.randn((8, m.embeddings_dim), generator=gen).to(dev)
    state = TS.init_train_state(params_g, gstate, mlp, emb)

    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    gt = f32(rng.uniform(0, 1, (res, res, 3)))
    sky_mask = f32(rng.uniform(size=(res, res)) > 0.3)
    occ = torch.ones((res, res), device=dev)
    bg = torch.zeros(3, device=dev)
    draw_gen = torch.Generator(device=dev).manual_seed(7)

    def step(st):
        return TS.train_step(st, cam, gt, sky_mask, occ, 0, TS.make_draws(draw_gen, mlp, cfg),
                             bg, mlp, cfg, rcfg, device=dev)

    _, aux = step(state)
    sync()
    loss, overflows = float(aux.loss), [aux.overflow]
    print(f"warm; loss={loss:.4f} overflow={int(aux.overflow)}", flush=True)

    t0 = time.perf_counter()
    st = state
    for _ in range(iters):
        st, aux = step(st)
        overflows.append(aux.overflow)
    sync()
    dt = (time.perf_counter() - t0) / iters
    print(f"train_step: {dt * 1e3:.2f} ms/iter  ({1.0 / dt:.2f} it/s)  "
          f"[render+shading+losses+adam, {n} Gaussians @ {res}x{res}]", flush=True)
    print(json.dumps({"metric": f"train_step_ms_{n}g_{res}x{res}", "ms_per_iter": dt * 1e3,
                      "its_per_s": 1.0 / dt, "iters": iters, "loss": loss,
                      "last_loss": float(aux.loss),
                      "overflow": int(torch.stack(overflows).max()), "max_dup": max_dup,
                      "backend": dev.type, "card": card_line(dev)}), flush=True)
    return dt * 1e3


def cli(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    flags = dict(a.split("=", 1) for a in argv if a.startswith("--") and "=" in a)
    pos = [a for a in argv if not a.startswith("--")]
    if set(flags) - {"--device"} or len(flags) + len(pos) != len(argv) or len(pos) > 3:
        raise SystemExit(f"usage: bench_train_step [n] [res] [iters] [--device=cpu] "
                         f"(got {argv})")
    env = [int(os.environ.get(k, d)) for k, d in (("TRAIN_BENCH_N", 500_000),
                                                  ("TRAIN_BENCH_RES", 800),
                                                  ("TRAIN_BENCH_ITERS", 10))]
    n, res, iters = [int(a) for a in pos] + env[len(pos):]
    main(n, res, iters, device=flags.get("--device", "cuda"))
    return 0


if __name__ == "__main__":
    sys.exit(cli())
