"""Viewer-driven serving demo: the port's network viewer (`viewer.ViewerServer`,
json protocol) serving a client that sweeps the camera, with end-to-end frame
latency (socket receive -> illumination MLP -> `render_rgb` -> uint8 on the
device -> socket send) at 1M Gaussians / 800x800 by default.

Port of the JAX package's `scripts/serve_demo.py`. The scene is the seeded
synthetic one (`synthetic.synthetic_scene`, n foreground + max(n // 100, 500)
sky Gaussians, density-consistent initial scales), with random MLP weights and
embeddings from a seeded generator and no optimizer state. The entry budget is
sized from the measured demand over the sweep's extremes (yaw -10, 0, 10
degrees) x 1.10. The client sends train=False (the stock GUI pause), so the
server loop serves continuously until the client disconnects. Every frame is
checked for its size; the record adds the device time of one frame (CUDA events
around `viewer._frame_u8`) and the served frames' launches of each CUDA kernel.

    python -m relightable3dgaussians_w_torch.scripts.serve_demo \\
        [n=1000000] [res=800] [frames=30] [--packed] [--skip-alpha=X] \\
        [--device=cpu] [--out=PATH]

It runs on the card unless --device=cpu is given, and writes one JSON record to
build/serve_demo/serve_demo.json (relative to the working directory) or --out,
and prints it.
"""

from __future__ import annotations

import json
import socket
import struct
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

from .. import synthetic, viewer
from ..config import Config
from ..device import resolve_device
from ..models import gaussians as G
from ..models.nets import MLPNet
from ..ops import preprocess
from ..ops.cuda import KERNEL_COUNTERS, launch_counts
from ..ops.rasterize import RasterizerConfig

DEFAULT_OUT = Path("build") / "serve_demo" / "serve_demo.json"
SWEEP_DEG = (-10.0, 10.0)
SERVE_TIMEOUT_S = 600
DEVICE_REPS = 10
class ServingHost:
    """What the viewer reads from its host: W, H, rcfg, cfg, mlp, state,
    bg_color (and the device the state lives on)."""

    def __init__(self, W, H, rcfg, cfg, mlp, state, bg_color, device):
        self.W, self.H, self.rcfg, self.cfg = W, H, rcfg, cfg
        self.mlp, self.state, self.bg_color, self.device = mlp, state, bg_color, device


def yaw(deg: float) -> np.ndarray:
    a = np.deg2rad(deg)
    view = np.eye(4, dtype=np.float32)
    view[0, 0], view[0, 2] = np.cos(a), np.sin(a)
    view[2, 0], view[2, 2] = -np.sin(a), np.cos(a)
    return view


def build_host(n: int, res: int, skip_alpha: float = 1.0 / 255.0, packed: bool = False,
               device="cuda"):
    """The serving host of an n-Gaussian synthetic scene at res x res. Returns
    (host, camera at yaw 0, entry demand: the most (Gaussian, tile) entries
    of yaw -10, 0 and 10 degrees)."""
    dev = resolve_device(device)
    # Density-consistent init scales (mean 3-NN d2 ~ (V / n)^(2/3), anchored to
    # 0.008 at 10k points): ~2-6 tiles a Gaussian at 1M points / 800x800.
    d2 = 0.008 * (10_000 / n) ** (2.0 / 3.0)
    params, gstate = synthetic.synthetic_scene(n=n, n_sky=max(n // 100, 500), d2=d2, device=dev)
    cfg = Config()
    cfg.runtime.serve_skip_alpha = skip_alpha
    cfg.runtime.serve_packed_rgb = packed
    m = cfg.model
    gen = torch.Generator().manual_seed(0)
    mlp = MLPNet(m.envlight_sh_degree, m.sky_sh_degree, m.embeddings_dim,
                 generator=gen).to(dev).eval()
    emb = torch.randn(4, m.embeddings_dim, generator=gen).to(dev)
    cam0 = synthetic.camera(res, res, device=dev)

    xyz, scl, quat = G.get_xyz(params, gstate), G.get_scaling(params), G.get_rotation(params)
    opa = G.get_opacity(params, gstate)[:, 0]
    demand = 0
    with torch.no_grad():
        for deg in (SWEEP_DEG[0], 0.0, SWEEP_DEG[1]):
            cam = synthetic.camera(res, res, viewmat=yaw(deg), device=dev)
            pre = preprocess.preprocess(xyz, scl, quat, cam.viewmat, cam.projmat, cam.tan_fovx,
                                        cam.tan_fovy, res, res, 16, active=gstate.alive,
                                        opacities=opa, skip_alpha=skip_alpha)
            demand = max(demand, int(pre.tiles_touched.sum()))
    # The static entry budget (sort and gather costs scale with it).
    max_dup = min(max(((int(demand * 1.10) + 4095) // 4096) * 4096, 4096), 1 << 23)
    rcfg = RasterizerConfig(width=res, height=res, max_dup=max_dup, skip_alpha=skip_alpha)
    state = viewer.ServeState(params, gstate, emb)
    host = ServingHost(res, res, rcfg, cfg, mlp, state, torch.zeros(3, device=dev), dev)
    return host, cam0, demand


def recv_exact(sock: socket.socket, n: int) -> bytes:
    out = b""
    while len(out) < n:
        chunk = sock.recv(n - len(out))
        if not chunk:
            raise ConnectionError("server closed")
        out += chunk
    return out


def client(port: int, fov: float, res: int, frames: int, result: list,
           done: threading.Event, train: bool = False):
    """Send `frames` json requests sweeping the yaw and read each frame:
    appends (seconds from request to the last byte, frame bytes) per frame, or
    the exception that stopped it; sets `done` at the end."""
    try:
        with socket.create_connection(("127.0.0.1", port), timeout=300) as sock:
            lo, hi = SWEEP_DEG
            for i in range(frames):
                deg = lo + (hi - lo) * i / max(frames - 1, 1)
                req = json.dumps({"viewmat": yaw(deg).tolist(), "fovx": fov,
                                  "fovy": fov, "width": res, "height": res, "train": train,
                                  "fix_sky": False, "embedding_index": 0}).encode()
                t0 = time.perf_counter()
                sock.sendall(struct.pack("<I", len(req)) + req)
                (ln,) = struct.unpack("<I", recv_exact(sock, 4))
                buf = recv_exact(sock, ln)
                result.append((time.perf_counter() - t0, buf))
    except Exception as exc:  # reported by the server loop
        result.append(exc)
    finally:
        done.set()


def serve_frames(host: ServingHost, cam0, frames: int, train: bool = False):
    """`frames` requests from a client thread through a ViewerServer on a free
    port. Returns (the client's [(seconds, frame bytes)], per served frame
    {each kernel's launches, "overflow", "entries"}). Raises
    unless every frame arrived at W * H * 3 bytes."""
    server = viewer.ViewerServer(port=0, protocol="json", device=host.device)
    per_frame = []
    last = [launch_counts()]
    send = server.send_image

    def send_and_count(image):   # one call per served frame
        send(image)
        if image is not None:
            now = launch_counts()
            per_frame.append(dict({k: now[k] - last[0][k] for k in now},
                                  overflow=int(server.last_aux.overflow),
                                  entries=int(server.last_aux.num_entries)))
            last[0] = now

    server.send_image = send_and_count
    fov = 2 * float(np.arctan(float(cam0.tan_fovx)))
    result, done = [], threading.Event()
    thread = threading.Thread(target=client, daemon=True,
                              args=(server.port, fov, host.W, frames, result, done, train))
    thread.start()
    try:
        deadline = time.time() + SERVE_TIMEOUT_S
        while not done.is_set() and time.time() < deadline:
            if not viewer.handle_viewer_request(server, host):
                time.sleep(0.001)
        thread.join(timeout=60)
    finally:
        server.close()
    errors = [r for r in result if isinstance(r, Exception)]
    if errors:
        raise errors[0]
    if len(result) != frames or len(per_frame) != frames:
        raise AssertionError(f"served {len(per_frame)}/{frames} frames, "
                             f"the client got {len(result)}")
    for i, (_, buf) in enumerate(result):
        if len(buf) != host.W * host.H * 3:
            raise AssertionError(f"frame {i}: {len(buf)} bytes, want {host.W * host.H * 3}")
    return result, per_frame


def device_frame_ms(host: ServingHost, cam, reps: int = DEVICE_REPS) -> float:
    """Mean time of one frame's device work (`viewer._frame_u8` at the served
    settings, embedding 0): CUDA events around `reps` frames on the card, the
    host clock on the CPU."""
    m, dev = host.cfg.model, host.device
    rcfg = viewer.serve_rcfg(host, host.W, host.H)
    with torch.inference_mode():
        envl, sky = host.mlp(host.state.embeddings[0][None])
        frame = lambda: viewer._frame_u8(host.state, envl[0], sky, cam, host.bg_color, rcfg,
                                         m.envlight_sh_degree, m.sky_sh_degree, m.specular,
                                         m.fix_sky, dev)[0]
        frame()   # warm
        if dev.type != "cuda":
            t0 = time.perf_counter()
            for _ in range(reps):
                frame()
            return (time.perf_counter() - t0) * 1e3 / reps
        torch.cuda.synchronize(dev)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            frame()
        end.record()
        torch.cuda.synchronize(dev)
        return start.elapsed_time(end) / reps


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    flags = {a.split("=", 1)[0]: a.split("=", 1)[1] if "=" in a else True
             for a in argv if a.startswith("--")}
    pos = [int(a) for a in argv if not a.startswith("--")]
    unknown = set(flags) - {"--packed", "--skip-alpha", "--device", "--out"}
    if unknown or len(pos) > 3:
        raise SystemExit("usage: serve_demo [n] [res] [frames] [--packed] [--skip-alpha=X] "
                         f"[--device=cpu] [--out=PATH] (got {argv})")
    n, res, frames = (pos + [1_000_000, 800, 30][len(pos):])[:3]
    skip_alpha = float(flags.get("--skip-alpha", 1.0 / 255.0))
    packed = bool(flags.get("--packed", False))
    dev = resolve_device(flags.get("--device", "cuda"))
    out = Path(flags.get("--out", DEFAULT_OUT))

    t0 = time.perf_counter()
    host, cam0, _ = build_host(n, res, skip_alpha, packed, dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    build_s = time.perf_counter() - t0
    result, per_frame = serve_frames(host, cam0, frames)
    device_ms = device_frame_ms(host, cam0)

    steady = [t * 1e3 for t, _ in result[1:]] or [result[0][0] * 1e3]
    record = {
        "kind": "viewer_serving_demo",
        "protocol": "json (length-prefixed; SIBR wire also supported)",
        "n_gaussians": n, "resolution": [res, res], "frames": frames,
        "skip_alpha": skip_alpha, "max_dup": host.rcfg.max_dup, "packed_rgb": packed,
        "backend": str(dev),
        "card": torch.cuda.get_device_name(dev) if dev.type == "cuda" else None,
        "build_s": build_s,
        "first_frame_ms_incl_compile": result[0][0] * 1e3,
        "steady_ms_per_frame_mean": float(np.mean(steady)),
        "steady_ms_per_frame_p50": float(np.median(steady)),
        "steady_fps": 1e3 / float(np.mean(steady)),
        "device_render_ms": device_ms,
        "device_fps": 1e3 / device_ms,
        "max_overflow": max(f["overflow"] for f in per_frame),
        "launches": {k: sum(f[k] for f in per_frame) for k in KERNEL_COUNTERS},
        "note": ("end-to-end: socket receive -> illumination MLP -> render_rgb (3-channel "
                 "serving path) -> uint8 on the device -> socket send, camera sweeping "
                 "-10..10 deg yaw; entry budget sized over the sweep's extremes; "
                 "device_render_ms: CUDA events around viewer._frame_u8"),
    }
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(record, indent=1))
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
