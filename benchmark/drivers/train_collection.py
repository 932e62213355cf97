"""The "train_collection" traffic kind: the port's trainer loop on a seeded
in-the-wild photo collection, timed in images stepped per second.

The collection is written from the seed in the NeRF-OSR layout the port
reads (COLMAP sparse/0 text with one PINHOLE camera a photo, `images/`,
`sky_masks/`, `masks/`, the `train/rgb` listing): the configuration's mix of
photo sizes, each photo's own horizontal field of view, JPEG photos and PNG
masks (the sky 0 above a wavy horizon, occluders 0 in a few ellipses), on a
thread pool. The cameras sit on the orbit of `drivers/train.py`'s views, one
photo a camera. Then, as `drivers/train.py`: the trainer is built, a copy of
its starting state kept, its loop driven through the set-up steps by the
stand-in of `train_step.train_step`, and timed over the window.

`correct` holds what `drivers/train.py` holds, against the reference run
from the same starting state on the same photos decoded anew and laid on the
canvas of the largest photo by `reference/collection.py`, and one exact
number more: the canvas elements of the set-up steps' views (image, sky mask,
occluder mask) that differ from the reference's decode of the same files
(`view_bytes_differ`; a canvas of another size counts every element).

The port's view store is imported first: a program that has none ends here,
with an ImportError, before any photo is written.
"""

from __future__ import annotations

from relightable3dgaussians_w_torch.data import view_store  # noqa: F401  (first: see above)

import math
import os
import resource
import shutil
import statistics
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
from PIL import Image

from .. import common, scene
from ..reference import collection as RC
from ..reference import lut as LUT
from . import compare
from .train import StandIn, WindowClosed, _capture_hooks, _unhook, flat, port_config


class CanvasStandIn(StandIn):
    """`drivers/train.py`'s stand-in that also keeps the canvases each set-up
    step received. With the fault "wrong_photo" every step is fed the canvas
    of the next photo instead of its own (`other(uid)`)."""

    def __init__(self, inner, faults=()):
        super().__init__(inner, faults)
        self.canvases = []
        self.other = None

    def __call__(self, state, cam, gt_image, sky_mask, occluders_mask, cam_uid, *args, **kwargs):
        if "wrong_photo" in self.faults:
            gt_image, sky_mask, occluders_mask = self.other(int(cam_uid))
        if self.mode == "setup" and self.calls < self.setup_steps:
            self.canvases.append([t.detach().cpu().clone()
                                  for t in (gt_image, sky_mask, occluders_mask)])
        return super().__call__(state, cam, gt_image, sky_mask, occluders_mask, cam_uid, *args,
                                **kwargs)


# ------------------------------------------------------------------ the collection


def collection_views(tr: dict, sc: dict, seed: int) -> list[dict]:
    """The photos: name, yaw and pose on the orbit, size (the mix, in a seeded
    order), focal length (a horizontal field of view uniform in the
    configuration's range) and what their pixels are drawn from."""
    rng = np.random.default_rng(common.derive_seed(seed, "collection"))
    sizes = [tuple(m["size"]) for m in sc["photo_mix"] for _ in range(m["photos"])]
    sizes = [sizes[i] for i in rng.permutation(len(sizes))]
    lo, hi = tr["yaw_range"]
    n = len(sizes)
    out = []
    for i, (W, H) in enumerate(sizes):
        deg = lo + (hi - lo) * i / max(n - 1, 1)
        fov = math.radians(rng.uniform(*sc["fov_x_deg_range"]))
        k = int(rng.integers(sc["occluders"][0], sc["occluders"][1] + 1))
        out.append({
            "name": f"photo_{i:04d}", "yaw": deg, "viewmat": scene.orbit_viewmat(
                deg, tr["orbit_center"]), "width": W, "height": H,
            "focal": float(f"{W / (2 * math.tan(fov / 2)):.17g}"),
            "colour": rng.random((3, 3)).astype(np.float32),
            "horizon": (rng.uniform(*sc["horizon_range"]), rng.uniform(0, 2 * math.pi),
                        rng.uniform(0.1, 0.3)),
            "occluders": (rng.uniform(*sc["occluder_share_range"]), rng.random((k, 4)))})
    return out


def photo(v: dict) -> np.ndarray:
    """A smooth colour ramp [H, W, 3] uint8 (`scene.photo`'s)."""
    W, H, c = v["width"], v["height"], v["colour"]
    x = (np.arange(W, dtype=np.float32) / W)[None, :, None]
    y = (np.arange(H, dtype=np.float32) / H)[:, None, None]
    img = (c[:, 0] * 0.6 + 0.2) + (c[:, 1] - 0.5) * 0.3 * x + (c[:, 2] - 0.5) * 0.3 * y
    return (np.clip(img, 0, 1) * 255).astype(np.uint8)


def sky_mask(v: dict) -> np.ndarray:
    """0 above a wavy horizon (its mean at the drawn share of the height, a
    wave of 2% of the height), 255 below."""
    W, H = v["width"], v["height"]
    level, phase, freq = v["horizon"]
    horizon = H * (level + 0.02 * np.sin(phase + freq * np.arange(W) / W * 2 * math.pi * 10))
    return np.where(np.arange(H)[:, None] < horizon[None, :], 0, 255).astype(np.uint8)


def occluder_mask(v: dict) -> np.ndarray:
    """255 but 0 inside k ellipses of equal area, share / k of the photo each
    (overlaps make the covered share a little less)."""
    W, H = v["width"], v["height"]
    share, draws = v["occluders"]
    m = np.full((H, W), 255, np.uint8)
    area = share * W * H / len(draws)
    for cx, cy, aspect, _ in draws:
        r = 2.0 ** (aspect * 2 - 1)                       # axis ratio in [1/2, 2]
        a = math.sqrt(area * r / math.pi)
        b = area / (math.pi * a)
        cx, cy = cx * W, cy * H
        x0, x1 = max(int(cx - a), 0), min(int(cx + a) + 1, W)
        y0, y1 = max(int(cy - b), 0), min(int(cy + b) + 1, H)
        yy, xx = np.mgrid[y0:y1, x0:x1]
        inside = ((xx - cx) / a) ** 2 + ((yy - cy) / b) ** 2 < 1
        m[y0:y1, x0:x1][inside] = 0
    return m


def write_collection(root: str, points: np.ndarray, views: list[dict], quality: int):
    """The NeRF-OSR layout (see the module's docstring), written on a thread
    pool; each photo's pixels are made in the thread that writes them."""
    for d in ("sparse/0", "images", "sky_masks", "masks", "train/rgb"):
        os.makedirs(os.path.join(root, d))

    def write(v):
        Image.fromarray(photo(v)).save(os.path.join(root, "images", v["name"] + ".jpg"),
                                       quality=quality)
        Image.fromarray(sky_mask(v)).save(
            os.path.join(root, "sky_masks", v["name"] + "_mask.png"), compress_level=1)
        Image.fromarray(occluder_mask(v)).save(
            os.path.join(root, "masks", v["name"] + ".png"), compress_level=1)
        open(os.path.join(root, "train/rgb", v["name"] + ".jpg"), "w").close()

    with ThreadPoolExecutor(os.cpu_count() or 1) as pool:
        list(pool.map(write, views))
    cams, imgs = [], []
    for i, v in enumerate(views):
        W, H, f = v["width"], v["height"], v["focal"]
        cams.append(f"{i + 1} PINHOLE {W} {H} {f:.17g} {f:.17g} {W / 2} {H / 2}")
        a = np.deg2rad(v["yaw"])   # the rotation is a yaw: q = (cos a/2, 0, sin a/2, 0)
        t = v["viewmat"][:3, 3]
        imgs += [f"{i + 1} {np.cos(a / 2):.17g} 0 {np.sin(a / 2):.17g} 0 "
                 f"{t[0]:.17g} {t[1]:.17g} {t[2]:.17g} {i + 1} {v['name']}.jpg", ""]
    with open(os.path.join(root, "sparse/0/cameras.txt"), "w") as f:
        f.write("\n".join(cams) + "\n")
    with open(os.path.join(root, "sparse/0/images.txt"), "w") as f:
        f.write("\n".join(imgs) + "\n")
    z = np.zeros(len(points), np.float32)
    g = np.full(len(points), 128.0, np.float32)
    scene.write_ply(os.path.join(root, "sparse/0/points3D.ply"),
                    {"x": points[:, 0], "y": points[:, 1], "z": points[:, 2], "nx": z, "ny": z,
                     "nz": z, "red": g, "green": g, "blue": g})


def paths(root: str, v: dict) -> tuple[str, str, str]:
    return (os.path.join(root, "images", v["name"] + ".jpg"),
            os.path.join(root, "sky_masks", v["name"] + "_mask.png"),
            os.path.join(root, "masks", v["name"] + ".png"))


# ------------------------------------------------------------------ the run


def run(cell: dict, seed: int, seconds: float, trace: bool, t_start: float, device="cuda",
        faults=()):
    """One run of the cell: (result, checks). `faults` as `drivers/train.py`'s,
    and "wrong_photo" (every step fed the next photo's canvas)."""
    from relightable3dgaussians_w_torch import train_step as TS
    from relightable3dgaussians_w_torch.ops.cuda import launch_counts
    from relightable3dgaussians_w_torch.trainer import Relightable3DGWTrainer

    from ..trace import TraceContext, TraceSlice

    cfg, tr = cell["config_data"], cell["traffic_data"]
    sc = cfg["scene"]
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    work = tempfile.mkdtemp(prefix="bench-collection-")
    stand_in = CanvasStandIn(TS.train_step, faults)
    parts = {"imports": time.perf_counter() - t_start}   # set-up's parts, in seconds
    try:
        # ---- inputs: points, the collection (the benchmark's, from the seed)
        gen = scene.generator(common.derive_seed(seed, "points"), dev)
        points = scene.points_in_box(sc["n_foreground"], sc["box"], gen, dev).cpu().numpy()
        views = collection_views(tr, sc, seed)
        data = os.path.join(work, "data")
        write_collection(data, points, views, sc["jpeg_quality"])
        trainer_seed = common.derive_seed(seed, "trainer") % (2 ** 31)
        pcfg = port_config(cfg, tr, data, os.path.join(work, "out"), trainer_seed)
        parts["dataset"] = time.perf_counter() - t_start - sum(parts.values())

        # ---- the program
        trainer = Relightable3DGWTrainer(pcfg, device=dev)
        parts["trainer"] = time.perf_counter() - t_start - sum(parts.values())
        store = trainer.train_views
        stand_in.other = lambda uid: [t.clone() for t in store.fetch((uid + 1) % len(store), 1)]
        start = {k: v.detach().clone() for k, v in flat(trainer.state.params).items()}
        gs = trainer.state.gauss_state
        pool = {"alive": gs.alive.clone(), "is_sky": gs.is_sky.clone(),
                "sky_center": gs.sky_center.clone()}
        zero_moments = all(float(torch.count_nonzero(v)) == 0
                           for v in flat(trainer.state.opt_state.mu).values())
        start_step = int(trainer.state.step)
        canvas = (trainer.H, trainer.W)

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
        host_peak_gb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024 / 1e9
        store_stats = store.stats()

        # ---- the window
        stand_in.mode = "window"
        stand_in.calls = 0
        hooks = None
        if trace:
            TraceSlice.warm()
            counts = lambda: dict(launch_counts(), **{
                f"view_store.{k}": v for k, v in store.stats().items()})
            stand_in.slice = TraceSlice(tr["trace_first_step"], tr["trace_steps"], counts)
            hooks = _capture_hooks(stand_in.slice)
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        before = store.stats()
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
        after = store.stats()
        window_s = stand_in.t_end - t0
        steps = stand_in.calls
        peak = torch.cuda.max_memory_allocated() if on_card else 0
        failed = sum(int(o) > 0 for o in stand_in.window_overflow)
        ctx = None
        if trace:
            sl = stand_in.slice
            d = {k: sl.counts1[f"view_store.{k}"] - sl.counts0[f"view_store.{k}"]
                 for k in ("fetch_photo_pixels", "fetches")}
            ctx = TraceContext(sl, {
                "kind": "train", "grid_x": (canvas[1] + 15) // 16,
                "pixels": d["fetch_photo_pixels"] / max(d["fetches"], 1),
                "live": int(trainer.state.gauss_state.alive.sum()),
                "step_s": (sl.t1 - sl.t0) / sl.steps,
                "store_bytes_per_pixel": after["device_bytes"] / after["pixels"],
                **{f"window_{k}": after[k] - before[k] for k in (
                    "fetches", "fetch_photo_pixels", "fetch_canvas_pixels")}})
        del trainer, now, store
        stand_in.other = None
        if on_card:
            torch.cuda.empty_cache()

        # ---- the reference, from the kept starting state
        t_ref = time.perf_counter()
        ok, checks, details = collection_checks(
            cell, start, pool, views, data, canvas, stand_in, losses_p, overflow_p, change_p,
            zero_moments, start_step, points, trainer_seed, dev, seed,
            control="control" in faults)
        checks["window_steps_overflowed"] = {"value": failed, "limit": 0}
        ok = ok and failed == 0
        details.update(setup_parts_s=parts, reference_s=time.perf_counter() - t_ref,
                       host_peak_rss_gb_setup=host_peak_gb, view_store=store_stats,
                       device_peak_gb_window=peak / 1e9)
        return {"correct": ok, "attempted": steps, "failed": failed, "peak": peak,
                "setup_s": setup_s, "window_s": window_s, "trace": ctx, "details": details,
                "metrics": {"train_images_per_s": steps / window_s}}, checks
    finally:
        TS.train_step = stand_in.inner
        shutil.rmtree(work, ignore_errors=True)


def canvases_differ(got, want) -> int:
    """The elements of the canvases `got` that differ from `want`'s; a canvas
    of another size counts all of its elements, or all of `want`'s if more."""
    return sum(int((g.to(w.device) != w).sum()) if g.shape == w.shape
               else max(g.numel(), w.numel()) for g, w in zip(got, want))


def collection_checks(cell, start, pool, views, data, canvas, stand_in, losses_p, overflow_p,
                      change_p, zero_moments, start_step, points, trainer_seed, dev, seed,
                      control=False):
    """`compare.train_checks`'s numbers on the collection, and
    `view_bytes_differ`. With `control` the reference computed with TF32
    matrix products stands in the program's place."""
    cfg = cell["config_data"]
    # The canvas is the largest photo's size, worked out from the collection;
    # a program on another canvas reads as every canvas element differing.
    H, W = max(v["height"] for v in views), max(v["width"] for v in views)
    fg_lut = LUT.fg_lut(device=dev)
    setup = stand_in.setup
    ref_views = [RC.view(views[uid], *paths(data, views[uid]), H, W, uid, dev)
                 for uid, _, _, _ in setup]
    first_p = stand_in.first_moments
    if control:
        losses_p, first_p, change_p = RC.steps(cfg, start, pool, ref_views, setup, start_step,
                                               dev, fg_lut, tf32=True)
    losses_r, first_r, change_r = RC.steps(cfg, start, pool, ref_views, setup, start_step, dev,
                                           fg_lut)
    med = statistics.median(first_r.values())
    moved = [k for k in start if first_r[k] >= compare.GRAD_FLOOR * med]
    values = {
        "loss_gap": max(abs(p - r) / abs(r) for p, r in zip(losses_p, losses_r)),
        "first_grad_gap": compare.worst_leaf_gap(first_p, first_r, start),
        "change_gap": compare.worst_leaf_gap(change_p, change_r, moved),
    }
    g = torch.Generator().manual_seed(common.derive_seed(seed, "start-sample"))
    sample = torch.randperm(points.shape[0], generator=g)[: cell["traffic_data"]["start_sample"]]
    sg = RC.start_gap(start, pool, points, views, cfg["model"], trainer_seed, sample,
                      control=control)
    fresh = zero_moments and start_step == 0
    values["start_exact_gap"] = sg["exact"] if fresh else math.inf
    values["start_scale_gap"] = sg["log_scale"] if fresh else math.inf
    values["start_sky_gap"] = sg["sky"] if fresh else math.inf
    # The canvases the program's steps received against the reference's decode
    # of the same files (the control's are the reference's own).
    differ = 0
    for got, v in zip(stand_in.canvases, ref_views):
        want = (v.image, v.sky_mask, v.occluders_mask)
        differ += canvases_differ(want if control else got, want)
    values["view_bytes_differ"] = float(differ)
    ok, checks = compare.judged(values, cell["limits"])
    checks["setup_steps_overflow"] = {"value": max(overflow_p), "limit": 0}
    leaf_gaps = {k: abs(first_p[k] - first_r[k]) / max(first_r[k], med) for k in start}
    return ok and max(overflow_p) == 0, checks, {
        "losses_program": losses_p, "losses_reference": losses_r,
        "canvas_program": list(canvas), "canvas_reference": [H, W],
        "first_grad_leaf_gaps": leaf_gaps, "compared_leaves": moved,
        "setup_views": [views[uid]["name"] for uid, _, _, _ in setup],
        "change_leaf_gaps": {k: abs(change_p[k] - change_r[k]) / max(change_r[k], 1e-30)
                             for k in moved}}
