"""Network viewer server: live rendering over a TCP socket.

Port of the JAX package's `viewer.py`, itself the reference's
`gaussian_renderer/network_gui.py`. Two wire protocols:

* ``protocol="sibr"``: the reference's binary layout, so the stock SIBR remote
  viewer connects unmodified. Request = 4-byte LE length + JSON with
  ``resolution_x/y, train, fov_y, fov_x, z_near, z_far, scaling_modifier,
  keep_alive, view_matrix, view_projection_matrix`` (row-major, SIBR's
  row-vector convention with columns 1 and 2 sign-flipped); response = raw RGB
  uint8 bytes (height*width*3) then a 4-byte LE length + the ASCII verify string.
* ``protocol="json"``: request = 4-byte LE length + JSON {"viewmat": 4x4,
  "fovx", "fovy", "width", "height", "fix_sky", "embedding_index"}; response =
  4-byte LE length + raw RGB uint8 bytes (height*width*3).

`try_connect` / `receive` / `send_image` are non-blocking so a host loop can poll.
Frames render on the server's device (CUDA by default) and are quantized to uint8
there, so 3 bytes per pixel cross to the host.

A served frame runs inside `torch.profiler` ranges: "viewer.request" (the
request's parse and the camera tensors on the device), "viewer.to_host" (the
wait for the frame and its copy to the host) and "viewer.send" (the payload and
the socket); the paused loop's sleep between requests is "viewer.wait". The MLP
("nets.mlp"), the shading ("renderer.shading") and the rasterizer's ranges fall
between the first two.
"""

from __future__ import annotations

import json
import socket
import struct
import time
from typing import NamedTuple

import numpy as np
import torch

from .device import resolve_device
from .models.gaussians import GaussianParams, GaussianState
from .ops.rasterize import CameraMatrices, RasterizerConfig
from .renderer import render_rgb
from .utils.graphics import projection_matrix

SEND_TIMEOUT_S = 30.0  # a client that takes longer to drain one frame is dropped


class ServeState(NamedTuple):
    """What a frame reads from the serving host's `state`."""
    gaussians: GaussianParams
    gauss_state: GaussianState
    embeddings: torch.Tensor   # [num_images, embeddings_dim]


def _to_u8(image: np.ndarray) -> np.ndarray:
    if image.dtype == np.uint8:
        return image
    return (np.clip(image, 0, 1) * 255).astype(np.uint8)


def _normalize_sibr(msg: dict) -> dict:
    """Reference SIBR message -> the canonical request dict.

    Mirrors network_gui.receive(): reshape row-major, negate view-matrix columns
    1 and 2 and view-projection column 1, then transpose both from SIBR's
    row-vector convention to the math convention (M @ [p, 1]).
    """
    w = int(msg.get("resolution_x", 0))
    h = int(msg.get("resolution_y", 0))
    if w == 0 or h == 0:
        return {"width": 0, "height": 0, "keep_alive": bool(msg.get("keep_alive", True)),
                "train": bool(msg.get("train", True))}
    view = np.asarray(msg["view_matrix"], np.float32).reshape(4, 4)
    view[:, 1] *= -1.0
    view[:, 2] *= -1.0
    proj = np.asarray(msg["view_projection_matrix"], np.float32).reshape(4, 4)
    proj[:, 1] *= -1.0
    return {
        "width": w,
        "height": h,
        "fovx": float(msg["fov_x"]),
        "fovy": float(msg["fov_y"]),
        "znear": float(msg.get("z_near", 0.01)),
        "zfar": float(msg.get("z_far", 100.0)),
        "viewmat": view.T,
        "projmat": proj.T,
        "scaling_modifier": float(msg.get("scaling_modifier", 1.0)),
        "train": bool(msg.get("train", True)),
        "keep_alive": bool(msg.get("keep_alive", True)),
    }


class ViewerServer:
    """Listening socket plus at most one client connection.

    `device` is where frames render; "cuda" (the default) raises when CUDA is
    absent. `last_aux` holds the RasterizeAux of the last frame served (entry
    count and budget overflow)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 6009,
                 protocol: str = "json", verify: str = "",
                 device: str | torch.device = "cuda"):
        if protocol not in ("json", "sibr"):
            raise ValueError(f"unknown viewer protocol {protocol!r}")
        self.device = resolve_device(device)
        self.protocol = protocol
        self.verify = verify             # SIBR handshake string (source path)
        self.last_aux = None
        self.listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.listener.bind((host, port))
        self.port = self.listener.getsockname()[1]   # resolves port=0
        self.listener.listen(1)
        self.listener.settimeout(0)
        self.conn: socket.socket | None = None

    def try_connect(self) -> bool:
        if self.conn is not None:
            return True
        try:
            self.conn, _ = self.listener.accept()
            self.conn.settimeout(0)
            return True
        except (BlockingIOError, socket.timeout):
            return False

    def receive(self) -> dict | None:
        if self.conn is None:
            return None
        try:
            header = self.conn.recv(4, socket.MSG_PEEK)
            if len(header) == 0:
                # Orderly shutdown: drop the connection so a new client can connect.
                self.close_conn()
                return None
            if len(header) < 4:
                return None
            (n,) = struct.unpack("<I", self.conn.recv(4))
            buf = b""
            self.conn.settimeout(1.0)
            while len(buf) < n:
                chunk = self.conn.recv(n - len(buf))
                if not chunk:
                    raise ConnectionError("client closed")
                buf += chunk
            self.conn.settimeout(0)
            msg = json.loads(buf)
            return _normalize_sibr(msg) if self.protocol == "sibr" else msg
        except (BlockingIOError, socket.timeout):
            return None
        except (ConnectionError, OSError):
            self.close_conn()
            return None

    def send_image(self, image: np.ndarray | None):
        """image: [H, W, 3] float in [0,1], or uint8 passed through as-is. None
        sends the SIBR verify string alone (a heartbeat reply); json sends nothing."""
        with torch.profiler.record_function("viewer.send"):
            if self.conn is None or (image is None and self.protocol == "json"):
                return
            if self.protocol == "sibr":
                v = self.verify.encode("ascii")
                payload = b"" if image is None else _to_u8(image).tobytes()
                payload += struct.pack("<I", len(v)) + v
            else:
                data = _to_u8(image).tobytes()
                payload = struct.pack("<I", len(data)) + data
            try:
                # The connection is non-blocking between requests, and sendall on
                # a non-blocking socket gives up once the send buffer is full,
                # which one frame of a few MB fills: block (with a timeout) while
                # sending.
                self.conn.settimeout(SEND_TIMEOUT_S)
                self.conn.sendall(payload)
                self.conn.settimeout(0)
            except OSError:
                self.close_conn()

    def close_conn(self):
        if self.conn is not None:
            try:
                self.conn.close()
            finally:
                self.conn = None

    def close(self):
        self.close_conn()
        self.listener.close()


def handle_viewer_request(server: ViewerServer, host) -> bool:
    """Serve pending viewer requests. Returns True if at least one frame was served.

    `host` is any object with `W, H, rcfg, cfg, mlp, state` (a ServeState) and
    `bg_color`. While the client sends train=False requests, this keeps serving
    (the stock 3DGS GUI pause); a train=True request, or no pending request while
    unpaused, returns control to the caller.
    """
    if not server.try_connect():
        return False
    served = False
    paused = False
    while server.conn is not None:
        req = server.receive()
        if req is None:
            if paused:
                with torch.profiler.record_function("viewer.wait"):
                    time.sleep(0.005)    # client paused training: keep serving
                continue
            break
        paused = not req.get("train", True)
        if req.get("width", 0) == 0 or req.get("height", 0) == 0:
            server.send_image(None)      # heartbeat: keep-alive reply, no frame
            continue
        _serve_frame(server, host, req)
        served = True
        if not paused:
            break
    return served


def serve_rcfg(host, W: int, H: int, scale_modifier: float = 1.0) -> RasterizerConfig:
    """The render settings of a served W x H frame: the host's, with the
    serving runtime's skip_alpha and packed colors."""
    return host.rcfg._replace(
        width=W, height=H, scale_modifier=scale_modifier,
        skip_alpha=host.cfg.runtime.serve_skip_alpha,
        packed_rgb=host.cfg.runtime.serve_packed_rgb,
        # Viewer frames never train; row intervals pay only in fwd+bwd.
        row_intervals=False)


def _serve_frame(server: ViewerServer, host, req: dict):
    dev = server.device
    with torch.profiler.record_function("viewer.request"):
        W = int(req.get("width", host.W))
        H = int(req.get("height", host.H))
        viewmat = np.asarray(req["viewmat"], np.float32)
        fovx = float(req["fovx"])
        fovy = float(req["fovy"])
        if "projmat" in req:
            proj_full = np.asarray(req["projmat"], np.float32)
        else:
            proj_full = projection_matrix(
                float(req.get("znear", 0.01)), float(req.get("zfar", 100.0)),
                fovx, fovy) @ viewmat
        f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
        cam = CameraMatrices(
            viewmat=f32(viewmat),
            projmat=f32(proj_full),
            campos=f32(np.linalg.inv(viewmat)[:3, 3]),
            tan_fovx=f32(np.tan(fovx / 2)),
            tan_fovy=f32(np.tan(fovy / 2)),
        )
        rcfg = serve_rcfg(host, W, H, float(req.get("scaling_modifier", 1.0)))
        idx = int(req.get("embedding_index", 0))
    model = host.cfg.model
    with torch.inference_mode():
        host.mlp.eval()
        envl, sky_sh = host.mlp(host.state.embeddings[idx][None].to(dev))
        rgb_u8, aux = _frame_u8(host.state, envl[0], sky_sh, cam, host.bg_color, rcfg,
                                model.envlight_sh_degree, model.sky_sh_degree,
                                model.specular, bool(req.get("fix_sky", model.fix_sky)), dev)
        with torch.profiler.record_function("viewer.to_host"):
            frame = rgb_u8.cpu().numpy()
    server.last_aux = aux
    server.send_image(frame)


def _frame_u8(state: ServeState, envl, sky_sh, cam: CameraMatrices, bg,
              rcfg: RasterizerConfig, envl_deg: int, sky_deg: int, specular: bool,
              fix_sky: bool, device):
    """One viewer frame at the given render settings, quantized to uint8 on the
    device: 3 bytes per pixel leave the card, not 12."""
    rgb, aux = render_rgb(state.gaussians, state.gauss_state, envl, sky_sh, cam, rcfg, bg,
                          envlight_sh_degree=envl_deg, sky_sh_degree=sky_deg,
                          specular=specular, fix_sky=fix_sky, device=device)
    # Truncating cast, not round: the bytes equal the host-side
    # (np.clip(x, 0, 1) * 255).astype(uint8) the wire protocol promises.
    return (torch.clamp(rgb, 0.0, 1.0) * 255.0).to(torch.uint8), aux
