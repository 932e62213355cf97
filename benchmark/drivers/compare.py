"""The numbers that decide `correct`, each against its limit.

A cell's limits are `benchmark/limits/<cell>.json`: {number: limit}. A number
passes when it is finite and at most its limit. PERF.md gives the readings
each limit was set from.
"""

from __future__ import annotations

import math
import statistics

import numpy as np
import torch

from .. import common
from ..reference import init as RI
from ..reference import lut as LUT
from ..reference import render as RR
from ..reference import train as RT

GRAD_FLOOR = 1e-3   # leaves whose first gradient is under this share of the
                    # median leaf's move by round-off alone: no change compared


def judged(values: dict, limits: dict) -> tuple[bool, dict]:
    checks = {k: {"value": v, "limit": limits[k]} for k, v in values.items()}
    ok = all(math.isfinite(v) and v <= limits[k] for k, v in values.items())
    return ok, checks


def worst_leaf_gap(got: dict, want: dict, leaves) -> float:
    """max over leaves of |got - want| / max(want, the median leaf's want)."""
    leaves = list(leaves)
    med = statistics.median(want[k] for k in leaves)
    return max(abs(got[k] - want[k]) / max(want[k], med, 1e-30) for k in leaves)


# ------------------------------------------------------------------ training


def reference_view(view: dict, photo: np.ndarray, cfg_scene: dict, device) -> RT.View:
    """The camera and photo of a training view as the reference builds them
    from what the benchmark wrote (COLMAP pose and PINHOLE focal lengths)."""
    W, H = cfg_scene["width"], cfg_scene["height"]
    fovx, fovy = colmap_fovs(cfg_scene)
    vm = np.eye(4)
    vm[:3, :3] = RI.colmap_pose(view["yaw"])
    vm[:3, 3] = view["viewmat"][:3, 3]
    cam = RR.camera(vm.astype(np.float32), fovx, fovy, W, H, device)
    img = torch.as_tensor(photo.astype(np.float32) / 255.0, device=device)
    ones = torch.ones((H, W), device=device)
    return RT.View(cam, 0, img, ones, ones)


def colmap_fovs(cfg_scene: dict) -> tuple[float, float]:
    """The fields of view a reader of the written PINHOLE focal lengths gets."""
    from ..scene import fovs

    W, H = cfg_scene["width"], cfg_scene["height"]
    fx, fy = fovs(W, H, cfg_scene["fov_x_deg"])
    focal_x = float(f"{W / (2 * math.tan(fx / 2)):.17g}")
    focal_y = float(f"{H / (2 * math.tan(fy / 2)):.17g}")
    return 2 * math.atan(W / (2 * focal_x)), 2 * math.atan(H / (2 * focal_y))


def reference_steps(cell, start, pool, views, photos, setup, start_step, dev, fg_lut,
                    tf32=False):
    """The reference's set-up steps from the kept starting state, with the
    program's views and draws: (losses, first gradient norm of each leaf,
    norm of each leaf's change after the steps)."""
    cfg = cell["config_data"]
    params = {k: v.detach() for k, v in start.items()}
    mu = {k: torch.zeros_like(v) for k, v in params.items()}
    nu = {k: torch.zeros_like(v) for k, v in params.items()}
    count = 0
    losses, first = [], None
    for i, (uid, draws, _, _) in enumerate(setup):
        view = reference_view(views[uid], photos[uid], cfg["scene"], dev)._replace(uid=uid)
        d = RT.Draws(*[x.to(dev) for x in draws])
        loss, grads = RT.grads_of(params, pool, view, d, start_step + i, cfg["optimizer"],
                                  fg_lut, tf32=tf32)
        losses.append(loss)
        if i == 0:
            first = {k: float(torch.linalg.vector_norm(g.double())) for k, g in grads.items()}
        params, mu, nu, count = RT.adam_step(params, grads, mu, nu, count, start_step + i,
                                             cfg["optimizer"])
        del grads
    change = {k: float(torch.linalg.vector_norm((params[k] - start[k]).double())) for k in start}
    return losses, first, change


def train_checks(cell, start, pool, views, photos, stand_in, losses_p, overflow_p, change_p,
                 zero_moments, start_step, points, trainer_seed, dev, seed, control=False):
    """The training numbers and whether they pass. With `control` the
    reference computed with TF32 matrix products stands in the program's
    place (the benchmark's control)."""
    cfg = cell["config_data"]
    sc = cfg["scene"]
    fg_lut = LUT.fg_lut(device=dev)
    first_p = stand_in.first_moments
    if control:
        losses_p, first_p, change_p = reference_steps(cell, start, pool, views, photos,
                                                      stand_in.setup, start_step, dev, fg_lut,
                                                      tf32=True)
    losses_r, first_r, change_r = reference_steps(cell, start, pool, views, photos,
                                                  stand_in.setup, start_step, dev, fg_lut)
    med = statistics.median(first_r.values())
    moved = [k for k in start if first_r[k] >= GRAD_FLOOR * med]

    values = {
        "loss_gap": max(abs(p - r) / abs(r) for p, r in zip(losses_p, losses_r)),
        "first_grad_gap": worst_leaf_gap(first_p, first_r, start),
        "change_gap": worst_leaf_gap(change_p, change_r, moved),
    }
    fovx, fovy = colmap_fovs(sc)
    viewmats = []
    for v in views:
        vm = np.eye(4)
        vm[:3, :3] = RI.colmap_pose(v["yaw"])
        vm[:3, 3] = v["viewmat"][:3, 3]
        viewmats.append(vm.astype(np.float32))
    g = torch.Generator().manual_seed(common.derive_seed(seed, "start-sample"))
    sample = torch.randperm(points.shape[0], generator=g)[: cell["traffic_data"]["start_sample"]]
    sg = RI.start_gap(start, pool, points, viewmats, fovx, fovy, sc["width"], sc["height"],
                      cfg["model"], trainer_seed, len(views), sample, control=control)
    # The starting state's fixed leaves, layout, MLP and embeddings are exact
    # (limit 0); its 3-NN log scales and sky positions agree to rounding.
    fresh = zero_moments and start_step == 0
    values["start_exact_gap"] = sg["exact"] if fresh else math.inf
    values["start_scale_gap"] = sg["log_scale"] if fresh else math.inf
    values["start_sky_gap"] = sg["sky"] if fresh else math.inf
    ok, checks = judged(values, cell["limits"])
    checks["setup_steps_overflow"] = {"value": max(overflow_p), "limit": 0}
    leaf_gaps = {k: abs(first_p[k] - first_r[k]) / max(first_r[k], med) for k in start}
    return ok and max(overflow_p) == 0, checks, {
        "losses_program": losses_p, "losses_reference": losses_r,
        "first_grad_leaf_gaps": leaf_gaps, "compared_leaves": moved,
        "change_leaf_gaps": {k: abs(change_p[k] - change_r[k]) / max(change_r[k], 1e-30)
                             for k in moved}}


# ------------------------------------------------------------------ serving


def frame_gaps(got: np.ndarray, want: np.ndarray) -> dict:
    """Byte gaps of a served frame against the reference's."""
    d = np.abs(got.astype(np.int16) - want.astype(np.int16))
    return {"bytes_differ_share": float((d > 0).mean()),
            "bytes_off_by_2_share": float((d > 1).mean()),
            "max_byte_gap": float(d.max())}


def serve_checks(cell, splats, weights, emb, frames: dict, requests: list, dev, control=False):
    """Render each sampled request with the reference and compare the bytes
    the client received. frames: {request index: [H, W, 3] uint8}. With
    `control` the reference's frame computed with TF32 matrix products stands
    in the received frame's place."""
    fg_lut = LUT.fg_lut(device=dev)
    per = {}
    for i, got in sorted(frames.items()):
        r = requests[i % len(requests)]
        cam = RR.camera(np.asarray(r["viewmat"], np.float32), r["fovx"], r["fovy"],
                        r["width"], r["height"], dev)
        render = lambda tf32: RR.render_rgb_u8(splats, weights, emb[r["embedding_index"]], cam,
                                               fg_lut, tf32=tf32).cpu().numpy()
        if control:
            got = render(True)
        per[i] = frame_gaps(got, render(False))
    values = {"bytes_differ_share": max((p["bytes_differ_share"] for p in per.values()),
                                        default=math.inf)}
    ok, checks = judged(values, cell["limits"])
    return ok, checks, per
