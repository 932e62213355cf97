"""Data-parallel training throughput at 1, 2, 4, ... ranks: images/s, and the
scaling efficiency against one rank.

Port of the JAX repo's `scripts/bench_scaling.py`. JAX runs one program over a
data = n mesh of devices; here each rank is a process of its own
(`parallel/__init__.py`), so for each n the harness starts n rank processes
(this module with `--rank`), which meet over a tcp rendezvous on 127.0.0.1
(`parallel/multihost.maybe_initialize`, a timeout on every wait) and build a
data = n mesh. Every rank builds the same inputs (`build`): the synthetic
scene of the repository's entry module (`synthetic.synthetic_scene(n_gauss,
n_sky=512, cap=1.3 n_gauss)`), the camera at the origin (`synthetic.camera`),
n ground-truth images drawn from `np.random.RandomState(0)` in the JAX
script's order across the n loop (the draws for 1, 2, ..., n/2 come first),
all-ones sky and occluder masks, the MLP and n embeddings from a seeded
torch.Generator, each image's step draws from another; then it runs
`parallel/data_parallel.make_dp_train_step` once untimed, and `iters` times
between two synchronizes (host wall time; the slowest rank's time is the
step's), and on the card a few more for the device time of a step (the
slowest rank's), from which the device's idle share of a step follows. Rank
r runs on cuda:(r % visible cards).

    python -m relightable3dgaussians_w_torch.scripts.bench_scaling \\
        [--n-gauss 20000] [--res 128] [--iters 10] [--ranks K] \\
        [--device cuda|cpu] [--backend nccl|gloo] [--max-dup 65536]

K defaults to the visible cards (1 on the CPU). The backend is NCCL on the
card and gloo on the CPU unless --backend names one; nothing switches it by
itself. NCCL refuses two ranks on one card, so more NCCL ranks than cards
raise. Gloo ranks that share a card run only with --backend gloo: their
entries go under "shared_card", never under "scaling", since they measure
host-staged collectives and one card's time split between processes. With
--max-dup 0 the entry budget is sized from the scene's demand (x 1.3, in
multiples of 4096), so that no step overflows.

Prints the JAX script's line for each n, then one JSON line
{"scaling": {n: {"images_per_s", "efficiency", "ms_per_step",
"device_ms_per_step", "device_idle_share", "overflow", "loss",
"first_losses", "backend", "ranks_per_card", "card", "launches", ...}}},
with the run's sizes beside it; `run` returns the same object. A number
from the CPU, or from ranks sharing a card, is not the card's scaling.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from .. import synthetic, train_step as TS
from ..config import Config
from ..device import card_line, resolve_device
from ..models import gaussians as G
from ..models.nets import MLPNet
from ..ops.cuda import build as kernel_build
from ..ops.cuda import launch_counts, reset_launches
from ..ops.preprocess import preprocess
from ..ops.rasterize import RasterizerConfig
from ..parallel import data_parallel as DP
from ..parallel import multihost
from ..parallel.mesh import make_mesh
from ..utils.timing import device_ms, sync
from .bench import entry_budget

MODULE = "relightable3dgaussians_w_torch.scripts.bench_scaling"
N_SKY = 512
DRAW_SEED = 1
RANK_TIMEOUT_S = 600.0      # a rank group's wait; every rank is killed after it
DEVICE_ITERS = 3            # steps timed for the device time of one, on the card
_ROOT = Path(__file__).resolve().parents[2]


class Setup(NamedTuple):
    state: TS.TrainState
    batch: DP.CameraBatch
    draws: list
    mlp: MLPNet
    cfg: Config
    rcfg: RasterizerConfig
    bg: torch.Tensor


def gt_images(n: int, res: int) -> np.ndarray:
    """The ground truth [n, res, res, 3] of the n-rank run: RandomState(0)
    drawn for 1, 2, 4, ... images in turn, as the JAX script's loop draws."""
    rng, m = np.random.RandomState(0), 1
    while True:
        gt = rng.uniform(0, 1, (m, res, res, 3)).astype(np.float32)
        if m == n:
            return gt
        if m > n:
            raise ValueError(f"rank counts run 1, 2, 4, ...: got {n}")
        m *= 2


def demand(state: TS.TrainState, cam, res: int) -> int:
    """The state's entry demand at `cam`: its opacity-tightened tile entries."""
    p, s = state.params["gaussians"], state.gauss_state
    with torch.no_grad():
        pre = preprocess(G.get_xyz(p, s), G.get_scaling(p), G.get_rotation(p), cam.viewmat,
                         cam.projmat, cam.tan_fovx, cam.tan_fovy, res, res, 16,
                         opacities=G.get_opacity(p, s)[:, 0] * s.alive)
        return int(pre.tiles_touched.sum())


def build(n: int, n_gauss: int = 20_000, res: int = 128, max_dup: int = 1 << 16,
          device: str | torch.device = "cuda") -> Setup:
    """The inputs of the n-rank run, the same on every rank. max_dup = 0 sizes
    the budget from the demand (x 1.3, uncapped: `bench.entry_budget`)."""
    dev = resolve_device(device)
    params_g, gstate = synthetic.synthetic_scene(n=n_gauss, n_sky=N_SKY,
                                                 cap=int(n_gauss * 1.3), device=dev)
    gen = torch.Generator().manual_seed(0)
    mlp = MLPNet(generator=gen)
    emb = torch.randn((n, mlp.dense[0].in_features), generator=gen)
    mlp, emb = mlp.to(dev), emb.to(dev)
    state = TS.init_train_state(params_g, gstate, mlp, emb)
    cfg = Config()
    cfg.optimizer.reg_normal_from_iter = 0
    cam = synthetic.camera(res, res, device=dev)
    if max_dup == 0:
        max_dup = entry_budget(demand(state, cam, res), 1.3, cap=None)
    ones = torch.ones((n, res, res), device=dev)
    batch = DP.CameraBatch(*[torch.stack([x] * n) for x in cam],
                           gt_image=torch.as_tensor(gt_images(n, res), device=dev),
                           sky_mask=ones, occluders_mask=ones,
                           uid=torch.arange(n, device=dev))
    draw_gen = torch.Generator(device=dev).manual_seed(DRAW_SEED)
    draws = [TS.make_draws(draw_gen, mlp, cfg) for _ in range(n)]
    return Setup(state, batch, draws, mlp, cfg, RasterizerConfig(res, res, max_dup=max_dup),
                 torch.zeros(3, device=dev))


def rank_run(rank: int, world: int, port: int, n_gauss: int, res: int, iters: int,
             device: str, backend: str, max_dup: int, timeout_s: float) -> dict:
    """One rank of the n = world run: the DP step once untimed, then `iters`
    times between two synchronizes, then (on the card) DEVICE_ITERS more for
    the device time of a step (`utils.timing.device_ms`: the card's time
    with the host's gaps left out), outside the launch count. Returns its
    record."""
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    runtime = SimpleNamespace(coordinator_address=f"127.0.0.1:{port}", num_processes=world,
                              process_id=rank)
    multihost.maybe_initialize(runtime, dev, backend=backend, timeout_s=timeout_s)
    try:
        mesh = make_mesh(data=world, gauss=1, device=dev)
        s = build(world, n_gauss, res, max_dup, mesh.device)
        step = DP.make_dp_train_step(s.mlp, s.cfg, s.rcfg, mesh)
        reset_launches()
        state, m = step(s.state, s.batch, s.draws, s.bg)
        first_losses, loss = m.losses.tolist(), float(m.loss)
        overflows = [m.overflow]
        sync()
        multihost.sync_processes("bench_scaling.start", timeout_s)
        t0 = time.perf_counter()
        for _ in range(iters):
            state, m = step(state, s.batch, s.draws, s.bg)
            overflows.append(m.overflow)
        sync()
        seconds = (time.perf_counter() - t0) / max(iters, 1)
        launches = launch_counts()
        step_device_ms = (device_ms(lambda: step(state, s.batch, s.draws, s.bg), DEVICE_ITERS)
                          if dev.type == "cuda" else None)
        return {"rank": rank, "device": str(mesh.device), "seconds_per_step": seconds,
                "device_ms_per_step": step_device_ms,
                "overflow": int(torch.stack(overflows).max()), "loss": loss,
                "last_loss": float(m.loss), "first_losses": first_losses,
                "max_dup": s.rcfg.max_dup, "launches": launches,
                "card": card_line(mesh.device)}
    finally:
        dist.destroy_process_group()


def run_ranks(n: int, args: list[str], threads: int | None, timeout_s: float) -> list[dict]:
    """Start n rank processes of this module and wait for all of them, at most
    timeout_s; every rank is killed when one fails or the wait runs out."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    env["PYTHONPATH"] = os.pathsep.join(filter(None, [str(_ROOT), env.get("PYTHONPATH")]))
    if threads is not None:
        env["OMP_NUM_THREADS"] = str(threads)
    port = multihost.free_port()
    with tempfile.TemporaryDirectory(prefix="bench_scaling_") as tmp:
        procs = []
        try:
            for r in range(n):
                log = open(Path(tmp) / f"rank{r}.log", "w")
                procs.append((subprocess.Popen(
                    [sys.executable, "-m", MODULE, "--rank", str(r), "--world", str(n),
                     "--port", str(port), "--out", str(Path(tmp) / f"rank{r}.json"), *args],
                    cwd=_ROOT, env=env, stdout=log, stderr=subprocess.STDOUT), log))
            deadline = time.monotonic() + timeout_s
            failure = None
            for r, (proc, _) in enumerate(procs):
                try:
                    rc = proc.wait(timeout=max(deadline - time.monotonic(), 0.0))
                except subprocess.TimeoutExpired:
                    rc = f"no exit within {timeout_s:.0f} s"
                if rc != 0:
                    failure = f"rank {r} of {n} failed ({rc})"
                    break
        finally:
            for proc, log in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
                log.close()
        if failure:
            tails = "\n".join(f"--- rank {i}:\n{(Path(tmp) / f'rank{i}.log').read_text()[-3000:]}"
                              for i in range(len(procs)))
            raise RuntimeError(f"bench_scaling: {failure}:\n{tails}")
        return [json.loads((Path(tmp) / f"rank{r}.json").read_text()) for r in range(n)]


def run(n_gauss: int = 20_000, res: int = 128, iters: int = 10, ranks: int | None = None,
        device: str | torch.device = "cuda", backend: str | None = None,
        max_dup: int = 1 << 16, timeout_s: float = RANK_TIMEOUT_S, log=print) -> dict:
    """Measure n = 1, 2, 4, ... up to `ranks`; prints the JAX script's lines and
    the JSON line, and returns the JSON object."""
    dev = resolve_device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    ranks = ranks or (cards if dev.type == "cuda" else 1)
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("NCCL runs ranks on CUDA cards; the CPU's ranks take gloo")
    if backend == "nccl" and ranks > cards:
        raise ValueError(
            f"{ranks} NCCL ranks need {ranks} cards and this machine has {cards}: NCCL "
            f"refuses two ranks on one card. Ask for at most {cards} ranks, or pass "
            f"backend='gloo' for ranks that share a card (not a scaling measurement)")
    if dev.type == "cuda":
        kernel_build.build()    # once here, not in every rank
    args = ["--n-gauss", str(n_gauss), "--res", str(res), "--iters", str(iters),
            "--device", dev.type, "--backend", backend, "--max-dup", str(max_dup),
            "--timeout", str(timeout_s)]
    out = {"scaling": {}, "shared_card": {}}
    base, n = None, 1
    while n <= ranks:
        threads = None if dev.type == "cuda" else max(1, torch.get_num_threads() // n)
        recs = run_ranks(n, args, threads, timeout_s)
        seconds = max(r["seconds_per_step"] for r in recs)
        images_s = n / seconds
        base = images_s if base is None else base
        per_card = -(-n // cards) if cards else None
        dev_ms = None if dev.type != "cuda" else max(r["device_ms_per_step"] for r in recs)
        entry = {"images_per_s": images_s, "efficiency": images_s / (base * n),
                 "ms_per_step": seconds * 1e3, "device_ms_per_step": dev_ms,
                 "device_idle_share": None if dev_ms is None else 1.0 - dev_ms / (seconds * 1e3),
                 "overflow": max(r["overflow"] for r in recs), "loss": recs[0]["loss"],
                 "last_loss": recs[0]["last_loss"], "first_losses": recs[0]["first_losses"],
                 "max_dup": recs[0]["max_dup"], "backend": backend, "ranks_per_card": per_card,
                 "card": recs[0]["card"], "devices": [r["device"] for r in recs],
                 "launches": {k: sum(r["launches"][k] for r in recs) for k in recs[0]["launches"]}}
        if per_card is not None and per_card > 1:
            out["shared_card"][n] = entry
            log(f"ranks={n} sharing {cards} card(s) over {backend}: {images_s:.2f} images/s "
                f"(not a scaling number)")
        else:
            out["scaling"][n] = entry
            log(f"devices={n}: {images_s:.2f} images/s, scaling efficiency "
                f"{entry['efficiency']:.1%}")
        n *= 2
    if not out["shared_card"]:
        del out["shared_card"]
    out.update(n_gauss=n_gauss, n_sky=N_SKY, res=res, iters=iters, device=dev.type,
               backend=backend, cards=cards)
    log(json.dumps(out))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog=MODULE, description=__doc__.split("\n\n")[0])
    ap.add_argument("--n-gauss", type=int, default=20_000)
    ap.add_argument("--res", type=int, default=128)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--ranks", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", choices=("nccl", "gloo"), default=None)
    ap.add_argument("--max-dup", type=int, default=1 << 16)
    ap.add_argument("--timeout", type=float, default=RANK_TIMEOUT_S)
    # One rank of a run (started by `run_ranks`).
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--world", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--out", default=None, help=argparse.SUPPRESS)
    a = ap.parse_args(argv)
    if a.rank is not None:
        rec = rank_run(a.rank, a.world, a.port, a.n_gauss, a.res, a.iters, a.device, a.backend,
                       a.max_dup, a.timeout)
        Path(a.out).write_text(json.dumps(rec))
        return 0
    run(a.n_gauss, a.res, a.iters, a.ranks, a.device, a.backend, a.max_dup, a.timeout)
    return 0


if __name__ == "__main__":
    sys.exit(main())
