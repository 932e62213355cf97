"""Training self-check: render views of a known synthetic scene, train a fresh
model on them, and fail unless it learns.

Port of the JAX package's `scripts/selfcheck_train.py`. The ground-truth scene
is a colourful blob cloud (4,000 Gaussians) inside a sky shell (384 sky
Gaussians at radius 25), rendered by the port's own renderer from `views`
cameras on a +-0.5 rad arc, each view under its own environment light (a shared
base plus a per-view perturbation: the in-the-wild setting, which the
student's embeddings and MLP must absorb). The student starts from 2,000 random
points and trains on those images with the training step, densification
(every 100 iterations strictly between 100 and iters / 2, gradient threshold
2e-4, extent 3) and per-image lighting. The trajectory is the step's PSNR at
iteration 1 and every 100. The run fails (exit 1) unless

* the best PSNR >= $SELFCHECK_MIN_PSNR (default 21 dB),
* the best exceeds the first by >= $SELFCHECK_MIN_GAIN (default 6 dB),
* the mean over the last 300 iterations' checkpoints >= $SELFCHECK_MIN_TAIL
  (default 20 dB): a late regression cannot hide behind one early peak.

With --dp every step goes through `parallel.data_parallel.make_dp_train_step`
on a 1 x 1 mesh (per-image gradients, sequential Adam microsteps) in a
one-rank process group this script opens and closes: NCCL on the card, gloo on
the CPU, or the launcher's (env://) under torchrun.

    python -m relightable3dgaussians_w_torch.scripts.selfcheck_train \\
        [iters=1500] [res=128] [views=8] [--dp] [--device=cpu] [--out=PATH]

It runs on the card unless --device=cpu is given, and writes one JSON record per
checkpoint, then a summary, to build/selfcheck/selfcheck.jsonl (relative to the
working directory) or --out. The numpy draws (scene, lights, view order) come
from RandomState(0) in the JAX script's order; the rest from a torch.Generator
(the initial weights from a CPU generator with its seed, so they are the same on
every device; the step draws and the split samples from the generator itself),
or are injected (`build_selfcheck(draws=)`, `run_selfcheck(step_draws=)`).
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import time
from pathlib import Path
from types import SimpleNamespace
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from .. import train_step as TS
from ..config import Config
from ..device import resolve_device
from ..models import gaussians as G
from ..models.nets import MLPNet
from ..ops.rasterize import CameraMatrices, RasterizerConfig
from ..parallel import data_parallel as DP
from ..parallel.mesh import make_mesh
from ..parallel.multihost import free_port, maybe_initialize
from ..renderer import render
from ..utils.graphics import projection_matrix

N_GT, N_SKY, SKY_RADIUS = 4000, 384, 25.0
N_STUDENT, STUDENT_D2, STUDENT_POOL = 2000, 4e-4, 32768
MAX_DUP = 1 << 17
GRAD_THRESHOLD, EXTENT = 2e-4, 3.0
TAIL_ITERS = 300
DEFAULT_OUT = Path("build") / "selfcheck" / "selfcheck.jsonl"


class Setup(NamedTuple):
    """Everything a self-check run reads."""
    res: int
    n_views: int
    device: torch.device
    cams: list             # [n_views] CameraMatrices
    gts: list              # [n_views] [res, res, 3] ground-truth views
    state: TS.TrainState   # the student at step 0
    mlp: MLPNet
    cfg: Config
    rcfg: RasterizerConfig
    rng: np.random.RandomState   # continues with the view order
    generator: torch.Generator   # step draws and split samples
    ones: torch.Tensor           # [res, res] sky and occluder masks
    bg: torch.Tensor             # [3]


class Run(NamedTuple):
    trajectory: list       # [(iteration, psnr)]
    state: TS.TrainState
    seconds: float         # wall time of the loop
    overflow: int          # entry-budget overflow summed over every step


class Gates(NamedTuple):
    first: float
    best: float
    tail_mean: float
    ok: bool
    min_psnr: float
    min_gain: float
    min_tail: float


def make_camera(angle: float, device) -> CameraMatrices:
    """60-degree camera on a radius-4 arc, looking at the scene centre (0, 0, 4)."""
    fov = np.deg2rad(60)
    c = np.array([4.0 * np.sin(angle), 0.0, 4.0 - 4.0 * np.cos(angle)])
    fwd = np.array([0, 0, 4.0]) - c
    fwd /= np.linalg.norm(fwd)
    right = np.cross([0, 1, 0], fwd)
    right /= np.linalg.norm(right)
    up = np.cross(fwd, right)
    w2c = np.eye(4, dtype=np.float32)
    w2c[:3, :3] = np.stack([right, up, fwd], 0)
    w2c[:3, 3] = -w2c[:3, :3] @ c
    proj = projection_matrix(0.01, 100.0, fov, fov)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    return CameraMatrices(viewmat=f32(w2c), projmat=f32(proj @ w2c), campos=f32(c),
                          tan_fovx=f32(np.tan(fov / 2)), tan_fovy=f32(np.tan(fov / 2)))


def selfcheck_config() -> Config:
    """The training config of the self-check (densify_until_iter is iters // 2,
    set by `run_selfcheck`)."""
    cfg = Config()
    o = cfg.optimizer
    o.reg_normal_from_iter = 400
    o.densify_from_iter = 100
    o.densification_interval = 100
    o.opacity_reset_interval = 10**9
    return cfg


def build_selfcheck(res: int, n_views: int, device, generator: torch.Generator,
                    draws: dict | None = None) -> Setup:
    """The ground-truth scene and views and the student at step 0.

    draws: optional {"gt_albedo": [4000, 3], "mlp": MLPNet state dict,
    "embeddings": [n_views, 32]} in place of the generator's draws."""
    dev = resolve_device(device)
    draws = draws or {}
    host_gen = torch.Generator().manual_seed(generator.initial_seed())
    rng = np.random.RandomState(0)
    rcfg = RasterizerConfig(width=res, height=res, max_dup=MAX_DUP)

    # ---- ground truth: a colourful blob cloud and a sky shell
    pts = np.stack([rng.uniform(-1.5, 1.5, N_GT), rng.uniform(-1.5, 1.5, N_GT),
                    rng.uniform(2.0, 6.0, N_GT)], -1).astype(np.float32)
    gt_params, gt_state = G.init_from_points(pts, np.full(N_GT, 0.004, np.float32),
                                             N_GT + N_SKY, device=dev)
    theta = rng.uniform(0.1, 1.4, N_SKY)
    phi = rng.uniform(-1.4, 1.4, N_SKY)
    R = SKY_RADIUS
    sky_pts = np.stack([R * np.sin(theta) * np.sin(phi), -R * np.cos(theta),
                        4.0 + R * np.sin(theta) * np.cos(phi)], -1).astype(np.float32)
    gt_params, gt_state = G.augment_with_sky(gt_params, gt_state, sky_pts,
                                             np.full(N_SKY, 1.5, np.float32), R,
                                             np.array([0, 0, 4.0], np.float32))
    albedo = draws.get("gt_albedo")
    albedo = (torch.randn((N_GT, 3), generator=host_gen) if albedo is None
              else torch.as_tensor(np.array(albedo, np.float32)))
    gt_albedo = gt_params.albedo.clone()
    gt_albedo[:N_GT] = albedo.to(dev)
    gt_opacity = gt_params.opacity.clone()
    gt_opacity[:N_GT] = 2.0
    gt_params = gt_params._replace(albedo=gt_albedo, opacity=gt_opacity)
    # Per-view lighting: a shared base envlight plus a per-view perturbation.
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    envl_base = rng.uniform(0.0, 0.6, (25, 3))
    envl_gts = [f32(envl_base + rng.uniform(-0.12, 0.12, (25, 3))) for _ in range(n_views)]
    sky_gt = f32(rng.uniform(-0.2, 0.2, (1, 4, 3)))

    cams = [make_camera(a, dev) for a in np.linspace(-0.5, 0.5, n_views)]
    bg = torch.zeros(3, device=dev)
    ones = torch.ones((res, res), device=dev)
    with torch.no_grad():
        gts = [torch.clamp(render(gt_params, gt_state, e, sky_gt, c, rcfg, bg, ones,
                                  debug=False, device=dev).render, 0, 1)
               for c, e in zip(cams, envl_gts)]

    # ---- the student, from random points
    pts0 = np.stack([rng.uniform(-1.5, 1.5, N_STUDENT), rng.uniform(-1.5, 1.5, N_STUDENT),
                     rng.uniform(2.0, 6.0, N_STUDENT)], -1).astype(np.float32)
    # Small initial splats: at d2 = 0.01 the planar prior (lambda_scale x the
    # mean min scale) outweighs the image term for the first ~300 iterations.
    params_g, gstate = G.init_from_points(pts0, np.full(N_STUDENT, STUDENT_D2, np.float32),
                                          STUDENT_POOL, device=dev)
    cfg = selfcheck_config()
    m = cfg.model
    mlp = MLPNet(m.envlight_sh_degree, m.sky_sh_degree, m.embeddings_dim, generator=host_gen)
    if "mlp" in draws:
        mlp.load_state_dict(draws["mlp"])
    mlp = mlp.to(dev)
    emb = draws.get("embeddings")
    emb = (torch.randn((n_views, m.embeddings_dim), generator=host_gen) if emb is None
           else torch.as_tensor(np.array(emb, np.float32)))
    state = TS.init_train_state(params_g, gstate, mlp, emb.to(dev))
    return Setup(res, n_views, dev, cams, gts, state, mlp, cfg, rcfg, rng, generator, ones, bg)


def densify_due(it: int, iters: int, ocfg) -> bool:
    """The JAX script's densify predicate: every densification_interval,
    strictly between densify_from_iter and iters // 2."""
    return (it % ocfg.densification_interval == 0
            and ocfg.densify_from_iter < it < iters // 2)


@contextlib.contextmanager
def one_rank_group(device):
    """The process group of the 1 x 1 mesh, opened by
    `multihost.maybe_initialize` unless one runs already: the launcher's
    (env://) under torchrun, else one rank on a free 127.0.0.1 port.
    Destroyed on exit if opened here."""
    if dist.is_initialized():
        yield
        return
    if "WORLD_SIZE" in os.environ and "MASTER_ADDR" in os.environ:
        runtime = SimpleNamespace(coordinator_address=f"{os.environ['MASTER_ADDR']}:"
                                  f"{os.environ.get('MASTER_PORT', '')}")
    else:
        runtime = SimpleNamespace(coordinator_address=f"127.0.0.1:{free_port()}",
                                  num_processes=1, process_id=0)
    maybe_initialize(runtime, device)
    try:
        yield
    finally:
        dist.destroy_process_group()


def run_selfcheck(setup: Setup, iters: int, dp: bool = False, step_draws=None,
                  on_step=None, log=print) -> Run:
    """Train the student for `iters` iterations on a random view each.

    step_draws(it): optional stand-in for the generator's StepDraws at
    iteration `it`. on_step(it, aux) sees every step's aux (loss, psnr,
    overflow, num_alive). The PSNR is recorded (a host sync) at iteration 1
    and every 100."""
    s = setup
    cfg = s.cfg
    cfg.optimizer.densify_until_iter = iters // 2
    with one_rank_group(s.device) if dp else contextlib.nullcontext():
        if dp:
            mesh = make_mesh(1, 1, s.device)
            dp_step = DP.make_dp_train_step(s.mlp, cfg, s.rcfg, mesh)
            state = DP.shard_train_state(s.state, mesh)
            log("selfcheck: stepping through make_dp_train_step (1 x 1 mesh, "
                f"{dist.get_backend()})")
        else:
            state = s.state

        def step(state, vi, draws):
            if not dp:
                return TS.train_step(state, s.cams[vi], s.gts[vi], s.ones, s.ones, vi, draws,
                                     s.bg, s.mlp, cfg, s.rcfg, device=s.device)
            c = s.cams[vi]
            batch = DP.CameraBatch(c.viewmat[None], c.projmat[None], c.campos[None],
                                   c.tan_fovx.reshape(1), c.tan_fovy.reshape(1),
                                   s.gts[vi][None], s.ones[None], s.ones[None],
                                   torch.tensor([vi], device=s.device))
            return dp_step(state, batch, [draws], s.bg)

        trajectory = []
        overflow = torch.zeros((), dtype=torch.int64, device=s.device)
        t0 = time.perf_counter()
        for it in range(1, iters + 1):
            vi = int(s.rng.randint(s.n_views))
            draws = step_draws(it) if step_draws else TS.make_draws(s.generator, s.mlp, cfg)
            state, aux = step(state, vi, draws)
            overflow += aux.overflow
            if on_step is not None:
                on_step(it, aux)
            if it % 100 == 0 or it == 1:
                p = float(aux.psnr)
                trajectory.append((it, p))
                log(f"[{it}] loss={float(aux.loss):.4f} psnr={p:.2f} "
                    f"alive={int(aux.num_alive)} {it / (time.perf_counter() - t0):.2f} it/s")
            if densify_due(it, iters, cfg.optimizer):
                state, _ = TS.densify_step(state, GRAD_THRESHOLD, EXTENT, cfg,
                                           generator=s.generator)
        if s.device.type == "cuda":
            torch.cuda.synchronize(s.device)
        seconds = time.perf_counter() - t0
    return Run(trajectory, state, seconds, int(overflow))


def gates(trajectory, iters: int) -> Gates:
    """First, best and tail-mean PSNR of a trajectory, and whether they pass
    the gates ($SELFCHECK_MIN_PSNR / _MIN_GAIN / _MIN_TAIL, default 21 / 6 /
    20 dB). The tail is the checkpoints after iteration iters - 300 (the first
    checkpoint when there are none)."""
    first = trajectory[0][1]
    best = max(p for _, p in trajectory)
    tail = [p for it, p in trajectory if it > iters - TAIL_ITERS]
    tail_mean = float(np.mean(tail)) if tail else first
    min_psnr = float(os.environ.get("SELFCHECK_MIN_PSNR", 21.0))
    min_gain = float(os.environ.get("SELFCHECK_MIN_GAIN", 6.0))
    min_tail = float(os.environ.get("SELFCHECK_MIN_TAIL", 20.0))
    ok = best >= min_psnr and best - first >= min_gain and tail_mean >= min_tail
    return Gates(first, best, tail_mean, ok, min_psnr, min_gain, min_tail)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    flags = {a.split("=", 1)[0]: a.split("=", 1)[1] if "=" in a else True
             for a in argv if a.startswith("--")}
    pos = [int(a) for a in argv if not a.startswith("--")]
    unknown = set(flags) - {"--dp", "--device", "--out"}
    if unknown or len(pos) > 3:
        raise SystemExit(f"usage: selfcheck_train [iters] [res] [views] [--dp] "
                         f"[--device=cpu] [--out=PATH] (got {argv})")
    iters, res, n_views = (pos + [1500, 128, 8][len(pos):])[:3]
    dp = bool(flags.get("--dp", False))
    dev = resolve_device(flags.get("--device", "cuda"))
    out = Path(flags.get("--out", DEFAULT_OUT))

    setup = build_selfcheck(res, n_views, dev, torch.Generator(device=dev).manual_seed(0))
    print(f"rendered {n_views} GT views at {res}x{res} "
          f"(mean {float(torch.stack(setup.gts).mean()):.3f})")
    run = run_selfcheck(setup, iters, dp=dp)
    g = gates(run.trajectory, iters)
    its = iters / run.seconds
    print(f"PSNR first={g.first:.2f} best={g.best:.2f} tail_mean={g.tail_mean:.2f} "
          f"(gain {g.best - g.first:+.2f} dB); {its:.2f} it/s, {run.seconds:.1f} s, "
          f"overflow {run.overflow}")

    out.parent.mkdir(parents=True, exist_ok=True)
    with open(out, "w") as f:
        for it, p in run.trajectory:
            f.write(json.dumps({"iter": it, "psnr": p}) + "\n")
        f.write(json.dumps({"iters": iters, "res": res, "views": n_views, "first": g.first,
                            "best": g.best, "tail_mean": g.tail_mean, "dp_step": dp,
                            "device": str(dev), "its_per_s": its, "seconds": run.seconds,
                            "overflow": run.overflow, "ok": g.ok}) + "\n")
    print(f"wrote {out}")
    if not g.ok:
        print(f"SELFCHECK FAILED: best {g.best:.2f} < {g.min_psnr} or gain "
              f"{g.best - g.first:.2f} < {g.min_gain} dB or tail mean {g.tail_mean:.2f} < "
              f"{g.min_tail} - training quality regressed")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
