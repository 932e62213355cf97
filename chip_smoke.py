"""Smoke run of the torch port's serving path on one CUDA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from `relightable3dgaussians_w_torch/csrc/`,
builds the full-size synthetic scene (1,000,000 Gaussians + 10,000 sky
Gaussians, random MLP weights from a seed), then:

1. device:  the card (nvidia-smi name and power limit), torch/CUDA versions
            and the kernels' build time;
2. kernels: on the first frame's inputs, each kernel against its plain PyTorch
            version (expansion bitwise; compositor within the image tolerance:
            under 0.1% of pixels off by more than 1e-3, median error under
            1e-5), with median times over repeated launches (CUDA events) and
            each kernel's lower bound from the bytes and float32 operations
            this frame needs (H100 SXM: 3.35 TB/s, 67 TFLOP/s float32);
3. stages:  the frame's stages timed one by one with CUDA events;
4. serve:   frames through the port's ViewerServer (json protocol on
            127.0.0.1) sweeping yaw over -10..10 degrees, each checked for its
            byte count, a zero entry overflow and launches of both kernels;
5. reference: a 2,000-Gaussian 64x64 render on the card against the plain
            PyTorch path on the CPU.

Each phase prints one JSON line, with the card's nvidia-smi name and power
limit under "card". The last lines are the kernel table, the
nvidia-smi line and {"ok": true, "device": ...}. Any failed check raises, so
the script exits non-zero without the last line; it also exits non-zero when
no CUDA device is present.
"""

from __future__ import annotations

import json
import socket
import struct
import subprocess
import sys
import threading
import time

import numpy as np
import torch

from relightable3dgaussians_w_torch import synthetic, viewer
from relightable3dgaussians_w_torch.config import Config
from relightable3dgaussians_w_torch.models import gaussians as G
from relightable3dgaussians_w_torch.models.nets import MLPNet
from relightable3dgaussians_w_torch.ops import binning, composite, preprocess, rasterize
from relightable3dgaussians_w_torch.ops.cuda import build
from relightable3dgaussians_w_torch.ops.cuda import expand as expand_kernel
from relightable3dgaussians_w_torch.ops.cuda import tile_composite as composite_kernel
from relightable3dgaussians_w_torch.renderer import compute_colors, render_rgb

N_GAUSS = 1_000_000
N_SKY = 10_000
RES = 800
FRAMES = 8
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
FP32_OPS_PER_S = 67e12         # H100 SXM data sheet, float32 outside tensor cores
COMPOSITE_OPS_PER_PAIR = 24    # float ops per visited (pixel, entry) pair, C = 3
EXPAND_OPS_PER_SLOT = 4        # integer ops per written slot


def emit(obj):
    print(json.dumps(obj), flush=True)


def yaw(deg):
    a = np.deg2rad(deg)
    view = np.eye(4, dtype=np.float32)
    view[0, 0], view[0, 2] = np.cos(a), np.sin(a)
    view[2, 0], view[2, 2] = -np.sin(a), np.cos(a)
    return view


def median_ms(fn, iters):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        torch.cuda.synchronize()
        times.append(s.elapsed_time(e))
    return float(np.median(times))


def image_errors(got, want):
    err = (got.double() - want.double()).abs().flatten()
    return float(err.max()), float((err > 1e-3).double().mean()), float(err.median())


def check_image(got, want, what):
    mx, frac, med = image_errors(got, want)
    if not (frac < 1e-3 and med < 1e-5):
        raise AssertionError(f"{what}: {frac:.2e} of values off by >1e-3, median {med:.2e}")
    return mx, frac, med


class ServingHost:
    """What the viewer reads from its host: W, H, rcfg, cfg, mlp, state, bg_color."""

    def __init__(self, W, H, rcfg, cfg, mlp, state, bg_color):
        self.W, self.H, self.rcfg, self.cfg = W, H, rcfg, cfg
        self.mlp, self.state, self.bg_color = mlp, state, bg_color


def build_host(dev):
    d2 = 0.008 * (10_000 / N_GAUSS) ** (2.0 / 3.0)
    params, gstate = synthetic.synthetic_scene(n=N_GAUSS, n_sky=N_SKY, d2=d2, device=dev)
    gen = torch.Generator().manual_seed(0)
    cfg = Config()
    mlp = MLPNet(cfg.model.envlight_sh_degree, cfg.model.sky_sh_degree,
                 cfg.model.embeddings_dim, generator=gen).to(dev).eval()
    emb = torch.randn(4, cfg.model.embeddings_dim, generator=gen).to(dev)
    cam0 = synthetic.camera(RES, RES, device=dev)
    xyz, scl, quat = G.get_xyz(params, gstate), G.get_scaling(params), G.get_rotation(params)
    opa = G.get_opacity(params, gstate)[:, 0]
    demand = 0
    for deg in (-10.0, 0.0, 10.0):
        cam = synthetic.camera(RES, RES, viewmat=yaw(deg), device=dev)
        pre = preprocess.preprocess(xyz, scl, quat, cam.viewmat, cam.projmat, cam.tan_fovx,
                                    cam.tan_fovy, RES, RES, 16, active=gstate.alive,
                                    opacities=opa, skip_alpha=cfg.runtime.serve_skip_alpha)
        demand = max(demand, int(pre.tiles_touched.sum()))
    # Static entry budget sized from the sweep's measured demand x 1.10.
    max_dup = ((int(demand * 1.10) + 4095) // 4096) * 4096
    rcfg = rasterize.RasterizerConfig(width=RES, height=RES, max_dup=max_dup,
                                      skip_alpha=cfg.runtime.serve_skip_alpha)
    state = viewer.ServeState(params, gstate, emb)
    host = ServingHost(RES, RES, rcfg, cfg, mlp, state, torch.zeros(3, device=dev))
    return host, cam0, demand


def frame_inputs(host, deg, dev):
    """Everything render_rgb computes before the rasterizer, for one yaw."""
    p, s, m = host.state.gaussians, host.state.gauss_state, host.cfg.model
    cam = synthetic.camera(RES, RES, viewmat=yaw(deg), device=dev)
    envl, sky = host.mlp(host.state.embeddings[0][None])
    rgb, _ = compute_colors(p, s, envl[0], sky, m.envlight_sh_degree, m.sky_sh_degree,
                            cam.campos, m.specular, m.fix_sky)
    return cam, G.get_xyz(p, s), G.get_scaling(p), G.get_rotation(p), \
        G.get_opacity(p, s)[:, 0], rgb


def visited_pairs(feat, tile_start, tile_end, grid_x):
    """(pixel, entry) pairs a front-to-back walk visits before each pixel
    terminates: the data-dependent work of the compositor on this frame."""
    counts = tile_end - tile_start
    total = 0
    for t0, t1, length in composite._batches(counts.cpu().numpy(), 256, 1 << 24):
        tids = torch.arange(t0, t1, device=feat.device)
        alpha, _ = composite._tile_batch(feat, tile_start[t0:t1], counts[t0:t1], tids,
                                         grid_x, 16, length)
        p_inc = torch.cumprod(1.0 - alpha, dim=1)
        p_prev = torch.cat([torch.ones_like(p_inc[:, :1]), p_inc[:, :-1]], dim=1)
        valid = torch.arange(length, device=feat.device)[None, :] < counts[t0:t1, None]
        total += int(((p_prev >= composite.T_EPS) & valid[..., None]).sum())
    return total


def kernels_phase(host, dev):
    rcfg = host.rcfg
    gx, gy = rcfg.grid_x, rcfg.grid_y
    cam, xyz, scl, quat, opa, rgb = frame_inputs(host, -10.0, dev)
    pre = preprocess.preprocess(xyz, scl, quat, cam.viewmat, cam.projmat, cam.tan_fovx,
                                cam.tan_fovy, RES, RES, 16, active=host.state.gauss_state.alive,
                                opacities=opa, skip_alpha=rcfg.skip_alpha)
    n = xyz.shape[0]
    counts = pre.tiles_touched.contiguous()
    offsets = torch.cumsum(counts, 0) - counts
    rank = torch.empty(n, dtype=torch.int64, device=dev)
    rank[torch.argsort(pre.depth, stable=True)] = torch.arange(n, device=dev)
    rect_min = pre.rect_min.contiguous()
    rect_w = torch.clamp_min(pre.rect_max[:, 0] - pre.rect_min[:, 0], 1).int().contiguous()
    args = (counts, offsets, rect_min, rect_w, rank, gx, rcfg.max_dup)

    keys_k, gid_k = expand_kernel.expand_entries(*args)
    keys_p, gid_p = binning.expand_entries_plain(*args)
    torch.cuda.synchronize()
    if not (torch.equal(keys_k, keys_p) and torch.equal(gid_k, gid_p)):
        raise AssertionError("expand_entries kernel differs from its plain version")
    a_err = 0.0  # bitwise equal
    total = int(counts.sum())
    a_ms = median_ms(lambda: expand_kernel.expand_entries(*args), 20)
    a_plain_ms = median_ms(lambda: binning.expand_entries_plain(*args), 10)
    a_bytes = n * (4 + 8 + 8 + 4 + 8) + rcfg.max_dup * (8 + 4)
    a_ops = EXPAND_OPS_PER_SLOT * min(total, rcfg.max_dup)

    b = binning.bin_gaussians(pre, gx, gy, rcfg.max_dup)
    if int(b.overflow) != 0:
        raise AssertionError(f"entry budget overflow {int(b.overflow)} on the first frame")
    feat = torch.cat([pre.mean2d, pre.conic, opa[:, None], rgb], -1)[b.gauss_id.long()]
    feat = feat.contiguous()
    bg = host.bg_color
    out_k = composite_kernel.composite_forward(feat, b.tile_start, b.tile_end, bg, gx, gy)
    out_p = composite.composite_forward(feat, b.tile_start, b.tile_end, bg, gx, gy)
    torch.cuda.synchronize()
    img_k, tfin_k = rasterize._assemble_image(*out_k, rcfg, 3)
    img_p, tfin_p = rasterize._assemble_image(*out_p, rcfg, 3)
    if not torch.isfinite(img_k).all():
        raise AssertionError("compositor kernel produced non-finite values")
    img_err = check_image(img_k, img_p, "composite_forward image")
    alpha_err = check_image(tfin_k, tfin_p, "composite_forward final transmittance")
    b_ms = median_ms(lambda: composite_kernel.composite_forward(
        feat, b.tile_start, b.tile_end, bg, gx, gy), 20)
    b_plain_ms = median_ms(lambda: composite.composite_forward(
        feat, b.tile_start, b.tile_end, bg, gx, gy), 10)
    pairs = visited_pairs(feat, b.tile_start, b.tile_end, gx)
    T, P = gx * gy, 256
    b_bytes = total * feat.shape[1] * 4 + T * 2 * 8 + 3 * 4 + T * P * 4 * 4
    b_ops = COMPOSITE_OPS_PER_PAIR * pairs

    record = {"phase": "kernels", "frame": "yaw -10, embedding 0, 800x800",
          "gaussians": n, "entries": total, "max_dup": rcfg.max_dup,
          "visited_pairs": pairs,
          "expand": {"keys_ids_bitwise_equal": True, "ms": a_ms, "plain_ms": a_plain_ms},
          "composite": {"image_max_abs_err": img_err[0], "image_frac_over_1e-3": img_err[1],
                        "image_median_err": img_err[2], "tfin_max_abs_err": alpha_err[0],
                        "tfin_frac_over_1e-3": alpha_err[1], "crop": "none (full 800x800)",
                        "ms": b_ms, "plain_ms": b_plain_ms}}
    table = [
        dict(name="expand_entries", route="cuda",
             source="relightable3dgaussians_w_torch/csrc/expand.cu",
             replaces="relightable3dgaussians_w_tpu/ops/pallas/expand.py:58",
             max_abs_err=float(a_err), ms=a_ms, plain_ms=a_plain_ms,
             bound_ms=max(a_bytes / HBM_BYTES_PER_S, a_ops / FP32_OPS_PER_S) * 1e3,
             bound_by="bytes" if a_bytes / HBM_BYTES_PER_S >= a_ops / FP32_OPS_PER_S
             else "operations", library_ms=None),
        dict(name="composite_forward", route="cuda",
             source="relightable3dgaussians_w_torch/csrc/tile_composite.cu",
             replaces="relightable3dgaussians_w_tpu/ops/pallas/tile_composite.py:193",
             max_abs_err=img_err[0], ms=b_ms, plain_ms=b_plain_ms,
             bound_ms=max(b_bytes / HBM_BYTES_PER_S, b_ops / FP32_OPS_PER_S) * 1e3,
             bound_by="bytes" if b_bytes / HBM_BYTES_PER_S >= b_ops / FP32_OPS_PER_S
             else "operations", library_ms=None),
    ]
    return table, img_k, record


def stages_phase(host, dev, reps=5):
    """Median CUDA-event time of each stage of one frame (yaw 0)."""
    rcfg, p, s, m = host.rcfg, host.state.gaussians, host.state.gauss_state, host.cfg.model
    cam = synthetic.camera(RES, RES, viewmat=yaw(0.0), device=dev)
    times = {}
    for _ in range(reps):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(8)]
        ev[0].record()
        envl, sky = host.mlp(host.state.embeddings[0][None])
        ev[1].record()
        xyz, scl, quat = G.get_xyz(p, s), G.get_scaling(p), G.get_rotation(p)
        opa = G.get_opacity(p, s)[:, 0]
        rgb, _ = compute_colors(p, s, envl[0], sky, m.envlight_sh_degree, m.sky_sh_degree,
                                cam.campos, m.specular, m.fix_sky)
        ev[2].record()
        pre = preprocess.preprocess(xyz, scl, quat, cam.viewmat, cam.projmat, cam.tan_fovx,
                                    cam.tan_fovy, RES, RES, 16, active=s.alive, opacities=opa,
                                    skip_alpha=rcfg.skip_alpha)
        ev[3].record()
        b = binning.bin_gaussians(pre, rcfg.grid_x, rcfg.grid_y, rcfg.max_dup)
        ev[4].record()
        feat = torch.cat([pre.mean2d, pre.conic, opa[:, None], rgb], -1)[b.gauss_id.long()]
        ev[5].record()
        out = composite_kernel.composite_forward(feat, b.tile_start, b.tile_end,
                                                 host.bg_color, rcfg.grid_x, rcfg.grid_y)
        ev[6].record()
        img, _ = rasterize._assemble_image(*out, rcfg, 3)
        (torch.clamp(img, 0.0, 1.0) * 255.0).to(torch.uint8).cpu()
        ev[7].record()
        torch.cuda.synchronize()
        for i, name in enumerate(("mlp", "shading", "preprocess", "binning", "gather",
                                  "composite", "quantize_copy")):
            times.setdefault(name, []).append(ev[i].elapsed_time(ev[i + 1]))
    med = {k: float(np.median(v)) for k, v in times.items()}

    # Device busy share of whole frames (the viewer's frame function, back to
    # back): kernel and copy time from the profiler over host wall time.
    frame = lambda: viewer._frame_u8(host.state, envl[0], sky, cam, host.bg_color, rcfg,
                                     m.envlight_sh_degree, m.sky_sh_degree, m.specular,
                                     m.fix_sky, dev)[0].cpu()
    frame()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            frame()
        wall_ms = (time.perf_counter() - t0) * 1e3 / reps
    dev_events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in dev_events) / 1e3 / reps
    top = sorted(dev_events, key=lambda e: -e.self_device_time_total)[:8]
    return {"phase": "stages", "frame": "yaw 0, 800x800", "median_ms": med,
          "sum_ms": sum(med.values()), "profiled_frame_wall_ms": wall_ms,
          "profiled_device_busy_ms": busy_ms,
          "device_idle_share": 1.0 - busy_ms / wall_ms if busy_ms > 0 else None,
          "kernels_per_frame": sum(e.count for e in dev_events) / reps,
          "top_device_ms_per_frame": {e.key[:60]: e.self_device_time_total / 1e3 / reps
                                      for e in top}}


def _recv(sock, n):
    out = b""
    while len(out) < n:
        chunk = sock.recv(n - len(out))
        if not chunk:
            raise ConnectionError("server closed")
        out += chunk
    return out


def _client(port, fov, frames, result, done):
    try:
        with socket.create_connection(("127.0.0.1", port), timeout=300) as sock:
            for i in range(frames):
                deg = -10.0 + 20.0 * i / max(frames - 1, 1)
                req = json.dumps({"viewmat": yaw(deg).tolist(), "fovx": fov, "fovy": fov,
                                  "width": RES, "height": RES, "train": True,
                                  "fix_sky": False, "embedding_index": 0}).encode()
                t0 = time.perf_counter()
                sock.sendall(struct.pack("<I", len(req)) + req)
                (ln,) = struct.unpack("<I", _recv(sock, 4))
                buf = _recv(sock, ln)
                result.append((time.perf_counter() - t0, buf))
    except Exception as exc:  # reported by the server loop
        result.append(exc)
    finally:
        done.set()


def serve_phase(host, cam0, ref_img, dev):
    expand_kernel.launches = 0
    composite_kernel.launches = 0
    server = viewer.ViewerServer(port=0, protocol="json", device=dev)
    fov = 2 * float(np.arctan(float(cam0.tan_fovx)))
    result, done = [], threading.Event()
    client = threading.Thread(target=_client, args=(server.port, fov, FRAMES, result, done),
                              daemon=True)
    client.start()
    per_frame = []
    try:
        deadline = time.time() + 600
        while not done.is_set() and time.time() < deadline:
            a0, b0 = expand_kernel.launches, composite_kernel.launches
            if viewer.handle_viewer_request(server, host):
                per_frame.append((expand_kernel.launches - a0, composite_kernel.launches - b0,
                                  int(server.last_aux.overflow),
                                  int(server.last_aux.num_entries)))
            else:
                time.sleep(0.001)
        client.join(timeout=60)
    finally:
        server.close()
    errors = [r for r in result if isinstance(r, Exception)]
    if errors:
        raise errors[0]
    if len(result) != FRAMES or len(per_frame) != FRAMES:
        raise AssertionError(f"served {len(per_frame)} frames, client got {len(result)}")
    for i, ((_, buf), (da, db, ovf, _)) in enumerate(zip(result, per_frame)):
        if len(buf) != RES * RES * 3:
            raise AssertionError(f"frame {i}: {len(buf)} bytes")
        if ovf != 0:
            raise AssertionError(f"frame {i}: entry overflow {ovf}")
        if da < 1 or db < 1:
            raise AssertionError(f"frame {i}: kernel launches expand={da} composite={db}")
    # The first request is the kernel phase's frame: same bytes up to a
    # truncation at a float boundary.
    first = np.frombuffer(result[0][1], np.uint8).astype(int)
    want = (torch.clamp(ref_img, 0.0, 1.0) * 255.0).to(torch.uint8).cpu().numpy().ravel()
    diff = np.abs(first - want)
    if diff.max() > 1 or (diff > 0).mean() > 1e-3:
        raise AssertionError(f"served frame differs from the kernel phase's: max {diff.max()}")
    if first.max() == first.min():
        raise AssertionError("served frame is constant")
    steady = [t * 1e3 for t, _ in result[1:]]
    record = {"phase": "serve", "frames": FRAMES, "resolution": [RES, RES],
          "entries_per_frame": [f[3] for f in per_frame], "overflow": 0,
          "launches": {"expand_entries": expand_kernel.launches,
                       "composite_forward": composite_kernel.launches},
          "first_frame_ms": result[0][0] * 1e3,
          "steady_ms_per_frame_mean": float(np.mean(steady)),
          "steady_ms_per_frame_median": float(np.median(steady)),
          "first_frame_bytes_off_by_one": int((diff > 0).sum())}
    return (expand_kernel.launches, composite_kernel.launches), record


def reference_phase(dev):
    """A small scene on the card against the plain path on the CPU."""
    p, s = synthetic.synthetic_scene(n=2000, n_sky=200, seed=3)
    rng = np.random.RandomState(5)
    envl = torch.as_tensor(rng.uniform(0, 0.5, (25, 3)).astype(np.float32))
    sky = torch.as_tensor(rng.uniform(0, 0.3, (1, 4, 3)).astype(np.float32))
    cam = synthetic.camera(64, 64)
    rcfg = rasterize.RasterizerConfig(width=64, height=64, max_dup=1 << 15)
    bg = torch.tensor([0.1, 0.2, 0.3])
    img_c, aux_c = render_rgb(p, s, envl, sky, cam, rcfg, bg, device=dev)
    img_p, aux_p = render_rgb(p, s, envl, sky, cam, rcfg, bg, device="cpu")
    if int(aux_c.num_entries) != int(aux_p.num_entries):
        raise AssertionError("entry counts differ between the card and the CPU")
    err = check_image(img_c.cpu(), img_p, "64x64 render vs CPU plain path")
    return {"phase": "reference", "scene": "2000+200 Gaussians, 64x64",
          "entries": int(aux_c.num_entries), "image_max_abs_err": err[0],
          "image_frac_over_1e-3": err[1], "image_median_err": err[2]}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    smi_line = smi.stdout.strip().splitlines()[0]
    report = lambda rec: emit({**rec, "card": smi_line})  # every number with its card
    t0 = time.perf_counter()
    build.build()
    build_s = time.perf_counter() - t0
    report({"phase": "device", "kind": torch.cuda.get_device_name(0),
            "torch": torch.__version__, "cuda": torch.version.cuda, "kernel_build_s": build_s})

    with torch.inference_mode():
        t0 = time.perf_counter()
        host, cam0, demand = build_host(dev)
        torch.cuda.synchronize()
        report({"phase": "scene", "gaussians": N_GAUSS + N_SKY, "resolution": [RES, RES],
                "entry_demand": demand, "max_dup": host.rcfg.max_dup,
                "build_s": time.perf_counter() - t0})
        table, ref_img, record = kernels_phase(host, dev)
        report(record)
        report(stages_phase(host, dev))
        launches, record = serve_phase(host, cam0, ref_img, dev)
        report(record)
        report(reference_phase(dev))
    for entry, n in zip(table, launches):
        entry["launches"] = n
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms")
    emit({"kernels": [{k: e[k] for k in keys} for e in table]})
    print(smi_line, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
