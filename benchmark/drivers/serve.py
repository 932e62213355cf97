"""Driver of the "serve" traffic kind: relit frames served by the port's
viewer (`viewer.ViewerServer`, json protocol on 127.0.0.1, frames rendered by
`viewer.handle_viewer_request`) to one viewer, a client process in a
closed loop: it asks for the next frame once the last has come.

Set-up makes the scene, the MLP weights and the embeddings on the card from
the seed, hands them to the port as a serving host (the port's
`scripts/serve_demo.ServingHost`), sizes the entry budget from the port's
own preprocess at the sweep's two ends and its middle (the demand x the
traffic's headroom, in multiples of 4096, as the serving demo does), and
renders the warm-up frames. The window is the client's loop for `--seconds`,
the camera yawing back and forth over the sweep and the embedding (the
lighting) changing every frame; `frames_per_s` is the frames it received over
the window. A frame's latency runs from its request's first byte sent to the
frame's last byte received.

The frames render at the reference's `skip_alpha` (`reference/render.py`
ALPHA_MIN) with exact (not packed) colours. `correct` renders a sample of the
received frames (drawn from the seed over the window, with the first frame at
the sweep end of the larger demand) with the reference and compares the
bytes; a frame whose entries overflowed the budget makes the run not
correct.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from .. import common, scene
from ..reference import render as RR
from . import compare

CLIENT_WAIT_S = 60.0   # past the window's close, for the last frames
FRAME_RANGE = "benchmark.serve_frame"   # profiler range around each served frame


class _Sink:
    """A server stand-in that drops what the served path sends."""

    def __init__(self, device):
        self.device, self.last_aux = device, None

    def send_image(self, image):
        pass


def requests_of(tr: dict, cfg_scene: dict, seed: int) -> list[dict]:
    """One period of the client's requests, which it cycles through: yaw back
    and forth over tr["yaw_range"] in steps of tr["yaw_step_deg"], the
    embedding index cycling over tr["embeddings"]; both start where the seed
    says."""
    W, H = cfg_scene["width"], cfg_scene["height"]
    fovx, fovy = scene.fovs(W, H, cfg_scene["fov_x_deg"])
    lo, hi = tr["yaw_range"]
    steps = int(round((hi - lo) / tr["yaw_step_deg"]))
    period = 2 * steps
    g = np.random.default_rng(common.derive_seed(seed, "requests"))
    phase, e0 = int(g.integers(period)), int(g.integers(tr["embeddings"]))
    out = []
    for i in range(math.lcm(period, tr["embeddings"])):
        k = (phase + i) % period
        deg = lo + tr["yaw_step_deg"] * (k if k <= steps else period - k)
        view = np.eye(4)
        view[:3, :3] = scene.yaw_rotation(deg)
        out.append({"viewmat": view.astype(np.float32).tolist(), "fovx": fovx, "fovy": fovy,
                    "width": W, "height": H, "train": False, "fix_sky": False,
                    "embedding_index": (e0 + i) % tr["embeddings"], "yaw": deg})
    return out


def port_host(splats, weights, emb, cfg: dict, tr: dict, dev):
    """The port's serving host of the benchmark's scene, with its entry budget
    and each sweep end's demand."""
    from relightable3dgaussians_w_torch import viewer
    from relightable3dgaussians_w_torch.config import Config
    from relightable3dgaussians_w_torch.models import gaussians as G
    from relightable3dgaussians_w_torch.models.nets import MLPNet
    from relightable3dgaussians_w_torch.ops import preprocess
    from relightable3dgaussians_w_torch.ops.rasterize import RasterizerConfig
    from relightable3dgaussians_w_torch.scripts.serve_demo import ServingHost

    sc, m = cfg["scene"], cfg["model"]
    W, H = sc["width"], sc["height"]
    params = G.GaussianParams(*splats[:9])
    N = params.xyz.shape[0]
    z = torch.zeros(N, device=dev)
    gstate = G.GaussianState(splats.alive, splats.is_sky, splats.sky_center, z, z.clone(),
                             z.clone())
    pcfg = Config()
    pcfg.model.envlight_sh_degree, pcfg.model.sky_sh_degree = m["envlight_sh_degree"], m["sky_sh_degree"]
    pcfg.model.embeddings_dim, pcfg.model.specular = m["embeddings_dim"], m["specular"]
    pcfg.runtime.serve_skip_alpha = RR.ALPHA_MIN
    pcfg.runtime.serve_packed_rgb = False
    mlp = MLPNet(m["envlight_sh_degree"], m["sky_sh_degree"], m["embeddings_dim"],
                 m["mlp_dense"], generator=torch.Generator().manual_seed(0)).to(dev)
    mlp.load_state_dict(weights)
    mlp.eval()
    fovx, fovy = scene.fovs(W, H, sc["fov_x_deg"])
    xyz, scl, quat = G.get_xyz(params, gstate), G.get_scaling(params), G.get_rotation(params)
    opa = G.get_opacity(params, gstate)[:, 0]
    demand = {}
    with torch.no_grad():
        for deg in (tr["yaw_range"][0], 0.0, tr["yaw_range"][1]):
            view = np.eye(4, dtype=np.float32)
            view[:3, :3] = scene.yaw_rotation(deg)
            cam = RR.camera(view, fovx, fovy, W, H, dev)
            pre = preprocess.preprocess(xyz, scl, quat, cam.viewmat, cam.projmat, cam.tan_fovx,
                                        cam.tan_fovy, W, H, 16, active=gstate.alive,
                                        opacities=opa, skip_alpha=RR.ALPHA_MIN)
            demand[deg] = int(pre.tiles_touched.sum())
    max_dup = max(((int(max(demand.values()) * tr["budget_headroom"]) + 4095) // 4096) * 4096,
                  4096)
    rcfg = RasterizerConfig(width=W, height=H, max_dup=max_dup, skip_alpha=RR.ALPHA_MIN)
    host = ServingHost(W, H, rcfg, pcfg, mlp, viewer.ServeState(params, gstate, emb),
                       torch.zeros(3, device=dev), dev)
    return host, demand


def run(cell: dict, seed: int, seconds: float, trace: bool, t_start: float, device="cuda",
        faults=()):
    """One run of the cell: (result, checks). `faults` plants faults in the
    timed path for the benchmark's own tests ("frame_altered"); "control" puts
    the reference computed with TF32 matrix products in the received frames'
    place for the check (`benchmark.control`)."""
    from relightable3dgaussians_w_torch import viewer
    from relightable3dgaussians_w_torch.ops.cuda import launch_counts
    from relightable3dgaussians_w_torch.ops.cuda import tile_composite as TC

    from ..trace import TraceContext, TraceSlice

    cfg, tr = cell["config_data"], cell["traffic_data"]
    sc, model = cfg["scene"], cfg["model"]
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    work = tempfile.mkdtemp(prefix="bench-serve-")
    client = None
    serve_frame, hooks_on = viewer._serve_frame, False
    compose = TC.composite_forward
    parts = {"imports": time.perf_counter() - t_start}   # set-up's parts, in seconds
    lap = lambda name: parts.__setitem__(name, time.perf_counter() - t_start - sum(parts.values()))
    try:
        splats = scene.served_scene(sc, common.derive_seed(seed, "scene"), dev)
        weights = scene.mlp_weights(model, common.derive_seed(seed, "mlp"), dev)
        emb = scene.embeddings(tr["embeddings"], model["embeddings_dim"],
                               common.derive_seed(seed, "embeddings"), dev)
        lap("scene")
        host, demand = port_host(splats, weights, emb, cfg, tr, dev)
        lap("host_and_budget")

        requests = requests_of(tr, sc, seed)
        # warm-up: the served path itself, at this cell's shape, into a sink
        sink = _Sink(dev)
        for r in requests[: tr["warmup_frames"]]:
            viewer._serve_frame(sink, host, r)
        if on_card:
            torch.cuda.synchronize()
        lap("warm_up")
        # the frames the check reads: the first frames sent after seeded
        # times in the window, and the first frame at the sweep end of the
        # larger demand
        g = np.random.default_rng(common.derive_seed(seed, "sample"))
        far = max((d for d in demand if d != 0.0), key=lambda d: demand[d])
        at_far = [i for i, r in enumerate(requests) if abs(r["yaw"] - far) < 1e-9][:1]
        keep_after = sorted((g.random(tr["sample_frames"] - 1) * seconds).tolist())

        # the server and its spans
        server = viewer.ViewerServer(port=0, protocol="json", device=dev)
        spans, counts = [], []
        sl = None
        if trace:
            TraceSlice.warm()
            sl = TraceSlice(tr["trace_first_frame"], tr["trace_frames"], launch_counts)
        send = server.send_image

        last = []

        def timed_send(image):
            if "frame_altered" in faults and len(spans) - 1 in at_far and last:
                image = last[0]          # a stale answer: the previous frame again
            last[:] = [image]
            spans[-1].append(time.perf_counter())
            send(image)

        def timed_frame(srv, h, req):
            if sl is not None:
                sl.at(len(spans))
            spans.append([time.perf_counter()])
            with torch.profiler.record_function(FRAME_RANGE):
                serve_frame(srv, h, req)
            spans[-1].append(time.perf_counter())
            # the frame has synced (its bytes came to the host): two scalars
            # are read now, so no frame's device buffers are held
            aux = srv.last_aux
            counts.append((int(aux.num_entries), int(aux.overflow)))

        def captured_forward(feat, tile_start, tile_end, *a, **k):
            sl.capture("composite_forward", (feat, tile_start, tile_end))
            return compose(feat, tile_start, tile_end, *a, **k)

        server.send_image = timed_send
        viewer._serve_frame = timed_frame
        if sl is not None:
            TC.composite_forward = captured_forward
        hooks_on = True

        plan = {"port": server.port, "requests": [{k: v for k, v in r.items() if k != "yaw"}
                                                  for r in requests],
                "lead_s": tr["lead_s"], "seconds": seconds, "width": host.W, "height": host.H,
                "keep_after_s": keep_after, "keep_index": at_far, "frames_dir": work}
        plan_path, out_path = os.path.join(work, "plan.json"), os.path.join(work, "client.json")
        with open(plan_path, "w") as f:
            json.dump(plan, f)
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        client = subprocess.Popen([sys.executable, "-m", "benchmark.client", plan_path, out_path],
                                  cwd=str(common.ROOT))
        deadline = time.perf_counter() + tr["lead_s"] + seconds + CLIENT_WAIT_S
        while client.poll() is None or server.conn is not None:
            if not viewer.handle_viewer_request(server, host):
                time.sleep(0.0005)
            if time.perf_counter() > deadline:
                break
        server.close()
        if client.poll() is None:
            client.kill()
        client.wait(timeout=30)
        if sl is not None:
            sl.at(len(spans))     # after the last frame served
            sl.close()
        peak = torch.cuda.max_memory_allocated() if on_card else 0
        with open(out_path) as f:
            res = json.load(f)
        t0 = res["t0"]
        setup_s = t0 - t_start
        parts["server_and_client"] = setup_s - sum(parts.values())
        sent, done = np.asarray(res["sent"]), np.asarray(res["done"])
        lat = (done - sent[: len(done)]) * 1e3
        overflowed = sum(o > 0 for _, o in counts)
        missing = len(sent) - len(done)
        window_s = done[-1] - t0 if len(done) else math.inf
        metrics = {"frames_per_s": len(done) / window_s,
                   "frame_ms_p95": float(np.percentile(lat, 95)) if len(lat) else math.inf}
        # each frame's latency in parts: the request's wait for the server's
        # poll, the server's frame (MLP, render, the copy to the host), the
        # send, and the rest of the trip to the client's last byte
        sv = np.asarray([s for s in spans[: len(done)] if len(s) == 3]).reshape(-1, 3)
        n = len(sv)
        frame_parts = {"poll": (sv[:, 0] - sent[:n]) * 1e3, "render": (sv[:, 1] - sv[:, 0]) * 1e3,
                       "send": (sv[:, 2] - sv[:, 1]) * 1e3, "tail": (done[:n] - sv[:, 2]) * 1e3}
        wire = frame_parts["send"] + frame_parts["tail"]
        ctx = None
        if trace:
            n_mlp = sum(w.numel() for w in weights.values())
            ctx = TraceContext(sl, {"kind": "serve", "live": int(splats.alive.sum()),
                                    "mlp_params": n_mlp, "grid_x": (host.W + 15) // 16,
                                    "wire_ms": float(np.median(wire)) if n else None,
                                    "poll_ms": float(np.median(frame_parts["poll"])) if n else None},
                               step_range=FRAME_RANGE)
            ctx.info["step_s"] = ctx.window_s / sl.steps   # the frames' own time
        frames = {int(i): np.load(os.path.join(work, f"frame_{i}.npy")) for i in res["kept"]}
        entries = [e for e, _ in counts]
        max_dup = host.rcfg.max_dup
        del host
        if on_card:
            torch.cuda.empty_cache()

        t_ref = time.perf_counter()
        ok, checks, per = compare.serve_checks(cell, splats, weights, emb, frames, requests, dev,
                                               control="control" in faults)
        ok = (ok and not res["errors"] and missing == 0 and overflowed == 0
              and len(frames) >= 1)
        checks["frames_missing"] = {"value": missing, "limit": 0}
        checks["frames_overflowed"] = {"value": overflowed, "limit": 0}
        return {"correct": ok, "attempted": len(sent), "failed": missing + overflowed,
                "peak": peak,
                "setup_s": setup_s, "window_s": window_s, "trace": ctx, "metrics": metrics,
                "details": {"demand": {str(k): v for k, v in demand.items()},
                            "max_dup": max_dup, "entries_max": max(entries, default=0),
                            "client_errors": res["errors"], "frames_compared": per,
                            "setup_parts_s": parts,
                            "frame_parts_ms": {k: {"median": float(np.median(v)),
                                                   "mean": float(np.mean(v))}
                                               for k, v in frame_parts.items()} if n else {},
                            "reference_s": time.perf_counter() - t_ref}}, checks
    finally:
        if hooks_on:
            viewer._serve_frame = serve_frame
            TC.composite_forward = compose
        if client is not None and client.poll() is None:
            client.kill()
            client.wait(timeout=30)
        shutil.rmtree(work, ignore_errors=True)
