"""Driver of the "train" traffic kind: the port's trainer loop on a seeded
COLMAP scene, timed in images stepped per second.

Set-up writes the scene (the point cloud, the photos and their cameras) under
TMPDIR, builds `Relightable3DGWTrainer` on it, keeps a copy of the state it
starts from, and drives `trainer.train` through its first `setup_steps`
steps. A stand-in for `train_step.train_step` (the function the loop calls)
records each step's view, draws, loss and overflow and, after the last
set-up step, raises to leave the loop. The window then calls `trainer.train`
again on that same trainer; the stand-in raises once `--seconds` have passed,
so the loop's own overflow read and view choice are timed with the steps.

`correct` holds the set-up steps against the reference (`reference/train.py`)
run from the kept starting state with the same views and draws: each step's
loss, the first gradient as Adam took it (its first moment after one step,
over 1 - beta1) and the change of every parameter leaf after the set-up steps,
each leaf's norm against the reference's. The starting state itself is held
against the scene it came from (`reference/init.py`). A window step whose
entries overflowed the budget makes the run not correct.
"""

from __future__ import annotations

import os
import shutil
import tempfile
import time

import torch

from .. import common, scene
from . import compare

class WindowClosed(Exception):
    """Raised by the stand-in to leave the trainer's loop."""


def flat(params) -> dict:
    """The program's parameter tree as {"gaussians.<field>", "mlp.<name>", "embeddings"}."""
    out = {f"gaussians.{k}": v for k, v in params["gaussians"]._asdict().items()}
    out.update({f"mlp.{k}": v for k, v in params["mlp"].items()})
    out["embeddings"] = params["embeddings"]
    return out


class StandIn:
    """Takes the place of `train_step.train_step` while the trainer runs."""

    def __init__(self, inner, faults=()):
        self.inner, self.faults = inner, set(faults)
        self.mode = "setup"
        self.setup_steps = 0
        self.calls = 0
        self.deadline = None
        self.t_end = None
        self.setup = []            # (uid, draws, loss, overflow) of each set-up step
        self.first_moments = None  # {leaf: norm of mu / (1 - b1)} after set-up step 1
        self.window_overflow = []
        self.slice = None

    def __call__(self, state, cam, gt_image, sky_mask, occluders_mask, cam_uid, draws, *args,
                 **kwargs):
        if self.mode == "setup":
            if self.calls == self.setup_steps:
                raise WindowClosed
        else:
            # the traced slice is whole steps: the window ends after it
            if time.perf_counter() >= self.deadline and not (self.slice and self.slice.open):
                torch.cuda.synchronize() if torch.cuda.is_available() else None
                self.t_end = time.perf_counter()
                raise WindowClosed
            if self.slice is not None:
                self.slice.at(self.calls)
        if "half_batch" in self.faults:
            # half the image's pixels left out of the losses, the mean taken
            # over the rest
            occluders_mask = occluders_mask.clone()
            occluders_mask[: occluders_mask.shape[0] // 2] = 0.0
        new_state, aux = self.inner(state, cam, gt_image, sky_mask, occluders_mask, cam_uid,
                                    draws, *args, **kwargs)
        if "state_unchanged" in self.faults:
            new_state = state
        self.calls += 1
        if self.mode == "setup":
            self.setup.append((int(cam_uid), [d.detach().clone() for d in draws], aux.loss,
                               aux.overflow))
            if self.calls == 1:
                b1 = 0.9
                mu = flat(new_state.opt_state.mu)
                self.first_moments = {k: float(torch.linalg.vector_norm(v.double())) / (1 - b1)
                                      for k, v in mu.items()}
        else:
            self.window_overflow.append(aux.overflow)
        return new_state, aux


def port_config(cfg: dict, traffic: dict, source: str, model_path: str, seed: int):
    from relightable3dgaussians_w_torch.config import load_config

    m, o, rt = cfg["model"], cfg["optimizer"], dict(cfg["runtime"], **traffic.get("runtime", {}))
    over = [f"dataset.source_path={source}", f"dataset.model_path={model_path}",
            f"runtime.seed={seed}"]
    over += [f"model.{k}={m[k]}" for k in ("envlight_sh_degree", "sky_sh_degree",
                                           "embeddings_dim", "specular")]
    over += [f"optimizer.{k}={v}" for k, v in o.items()]
    over += [f"runtime.{k}={v}" for k, v in rt.items()]
    return load_config(over)


def run(cell: dict, seed: int, seconds: float, trace: bool, t_start: float, device="cuda",
        faults=()):
    """One run of the cell: (result, checks). `faults` plants faults in the
    timed path for the benchmark's own tests ("state_unchanged",
    "half_batch"); "control" puts the reference computed with TF32 matrix
    products in the program's place for the check (`benchmark.control`)."""
    from relightable3dgaussians_w_torch import train_step as TS
    from relightable3dgaussians_w_torch.ops.cuda import launch_counts
    from relightable3dgaussians_w_torch.trainer import Relightable3DGWTrainer

    from ..trace import TraceContext, TraceSlice

    cfg, tr = cell["config_data"], cell["traffic_data"]
    sc = cfg["scene"]
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    work = tempfile.mkdtemp(prefix="bench-train-")
    stand_in = StandIn(TS.train_step, faults)
    parts = {"imports": time.perf_counter() - t_start}   # set-up's parts, in seconds
    try:
        # ---- inputs: points, photos, cameras (the benchmark's, from the seed)
        gen = scene.generator(common.derive_seed(seed, "points"), dev)
        points = scene.points_in_box(sc["n_foreground"], sc["box"], gen, dev).cpu().numpy()
        views = scene.training_views(tr, sc)
        W, H = sc["width"], sc["height"]
        pgen = scene.generator(common.derive_seed(seed, "photos"), dev)
        photos = [scene.photo(W, H, pgen, dev) for _ in views]
        data = os.path.join(work, "data")
        scene.write_colmap_scene(data, points, views, photos, W, H, sc["fov_x_deg"])
        trainer_seed = common.derive_seed(seed, "trainer") % (2 ** 31)
        pcfg = port_config(cfg, tr, data, os.path.join(work, "out"), trainer_seed)
        parts["dataset"] = time.perf_counter() - t_start - sum(parts.values())

        # ---- the program
        trainer = Relightable3DGWTrainer(pcfg, device=dev)
        parts["trainer"] = time.perf_counter() - t_start - sum(parts.values())
        start = {k: v.detach().clone() for k, v in flat(trainer.state.params).items()}
        gs = trainer.state.gauss_state
        pool = {"alive": gs.alive.clone(), "is_sky": gs.is_sky.clone(),
                "sky_center": gs.sky_center.clone()}
        zero_moments = all(float(torch.count_nonzero(v)) == 0
                           for v in flat(trainer.state.opt_state.mu).values())
        start_step = int(trainer.state.step)

        TS.train_step = stand_in
        stand_in.setup_steps = tr["setup_steps"]
        try:
            trainer.train()
        except WindowClosed:
            pass
        now = flat(trainer.state.params)
        change_p = {k: float(torch.linalg.vector_norm((now[k] - start[k]).double()))
                    for k in start}
        losses_p = [float(s[2]) for s in stand_in.setup]
        overflow_p = [int(s[3]) for s in stand_in.setup]

        parts["setup_steps"] = time.perf_counter() - t_start - sum(parts.values())

        # ---- the window
        stand_in.mode = "window"
        stand_in.calls = 0
        hooks = None
        if trace:
            TraceSlice.warm()
            stand_in.slice = TraceSlice(tr["trace_first_step"], tr["trace_steps"], launch_counts)
            hooks = _capture_hooks(stand_in.slice)
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        setup_s = t0 - t_start
        stand_in.deadline = t0 + seconds
        try:
            trainer.train()
        except WindowClosed:
            pass
        finally:
            TS.train_step = stand_in.inner
            if hooks is not None:
                stand_in.slice.close()
                _unhook(hooks)
        window_s = stand_in.t_end - t0
        steps = stand_in.calls
        peak = torch.cuda.max_memory_allocated() if on_card else 0
        failed = sum(int(o) > 0 for o in stand_in.window_overflow)
        ctx = None
        if trace:
            sl = stand_in.slice
            ctx = TraceContext(sl, {"kind": "train", "pixels": W * H, "grid_x": (W + 15) // 16,
                                    "live": int(trainer.state.gauss_state.alive.sum()),
                                    "step_s": (sl.t1 - sl.t0) / sl.steps})
        del trainer, now
        if on_card:
            torch.cuda.empty_cache()

        # ---- the reference, from the kept starting state
        t_ref = time.perf_counter()
        ok, checks, details = compare.train_checks(
            cell, start, pool, views, photos, stand_in, losses_p, overflow_p, change_p,
            zero_moments, start_step, points, trainer_seed, dev, seed,
            control="control" in faults)
        # a window step whose entries overflowed the budget dropped some: its
        # answer is approximate, and the run is not correct
        checks["window_steps_overflowed"] = {"value": failed, "limit": 0}
        ok = ok and failed == 0
        details["setup_parts_s"] = parts
        details["reference_s"] = time.perf_counter() - t_ref
        return {"correct": ok, "attempted": steps, "failed": failed, "peak": peak,
                "setup_s": setup_s, "window_s": window_s, "trace": ctx, "details": details,
                "metrics": {"train_images_per_s": steps / window_s}}, checks
    finally:
        TS.train_step = stand_in.inner
        shutil.rmtree(work, ignore_errors=True)


def _capture_hooks(sl):
    """Wrap the kernel entry points a reader's bound needs, so the traced
    slice keeps each call's inputs."""
    from relightable3dgaussians_w_torch.ops.cuda import segment_sum as SS
    from relightable3dgaussians_w_torch.ops.cuda import tile_composite as TC

    saved = [(TC, "composite_backward", TC.composite_backward),
             (SS, "segment_sum_ordered", SS.segment_sum_ordered),
             (SS, "permute_entries", SS.permute_entries)]

    def bwd(feat, tile_start, tile_end, *a, **k):
        sl.capture("composite_backward", (feat, tile_start, tile_end))
        return saved[0][2](feat, tile_start, tile_end, *a, **k)

    def seg(rows, bounds, order, *a, **k):
        sl.capture("segment_sum_rows", (rows.shape[1], bounds.shape[0] - 1,
                                        (bounds[-1] - bounds[0]).clone()))
        return saved[1][2](rows, bounds, order, *a, **k)

    def perm(gid, perm_, total, *a, **k):
        sl.capture("permute_entries", (perm_.shape[0], total.clone()))
        return saved[2][2](gid, perm_, total, *a, **k)

    TC.composite_backward, SS.segment_sum_ordered, SS.permute_entries = bwd, seg, perm
    return saved


def _unhook(saved):
    for mod, name, fn in saved:
        setattr(mod, name, fn)
