"""The torch port's network viewer against the JAX package's, on the CPU: SIBR
message normalization, a json socket round trip whose frame bytes match the JAX
viewer's, the SIBR wire layout, the CUDA-by-default rule of the entry points,
and the port's import hygiene (no JAX anywhere in its import graph)."""

import json
import os
import socket
import struct
import subprocess
import sys
import threading
import time

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import __graft_entry__ as ge
from relightable3dgaussians_w_tpu import viewer as jviewer
from relightable3dgaussians_w_tpu.config import Config as JConfig
from relightable3dgaussians_w_tpu.models.nets import MLPNet as JMLPNet, init_embeddings, init_mlp
from relightable3dgaussians_w_tpu.ops.rasterize import RasterizerConfig as JRasterizerConfig
from relightable3dgaussians_w_tpu.train_step import TrainState

from relightable3dgaussians_w_torch import convert, renderer, synthetic, viewer
from relightable3dgaussians_w_torch.cli import tune
from relightable3dgaussians_w_torch.config import Config
from relightable3dgaussians_w_torch.models import light_cubemap
from relightable3dgaussians_w_torch.models.nets import MLPNet
from relightable3dgaussians_w_torch.ops import rasterize as trasterize

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _sibr_msg(rng, w, h):
    return {
        "resolution_x": w, "resolution_y": h, "train": True, "fov_y": 0.7, "fov_x": 0.9,
        "z_near": 0.01, "z_far": 100.0, "shs_python": False, "rot_scale_python": False,
        "keep_alive": True, "scaling_modifier": 0.8,
        "view_matrix": rng.randn(16).astype(np.float32).tolist(),
        "view_projection_matrix": rng.randn(16).astype(np.float32).tolist(),
    }


def test_normalize_sibr_matches_jax():
    rng = np.random.RandomState(7)
    for msg in (_sibr_msg(rng, 32, 16), {"resolution_x": 0, "resolution_y": 0, "train": False}):
        got, want = viewer._normalize_sibr(dict(msg)), jviewer._normalize_sibr(dict(msg))
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)


SOCKET_WAIT_S = 300  # room for a frame on a CPU shared by several test workers


def _connect(port):
    return socket.create_connection(("127.0.0.1", port), timeout=SOCKET_WAIT_S)


def _recv_exact(sock, n):
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        assert chunk, "server closed early"
        buf += chunk
    return buf


def _json_frame(server, handler, host, req):
    """One json request through a live socket; returns the frame bytes."""
    client = _connect(server.port)
    try:
        payload = json.dumps(req).encode()
        client.sendall(struct.pack("<I", len(payload)) + payload)
        t = threading.Thread(target=lambda: handler(server, host))
        deadline = time.time() + SOCKET_WAIT_S
        while not server.try_connect():
            assert time.time() < deadline, "server never accepted"
            time.sleep(0.01)
        t.start()
        (n,) = struct.unpack("<I", _recv_exact(client, 4))
        frame = _recv_exact(client, n)
        t.join(SOCKET_WAIT_S)
        assert not t.is_alive()
        return frame
    finally:
        client.close()


class _Host:
    pass


class _Capture:
    """Stands in for a ViewerServer: keeps the frame the viewer sends."""

    def send_image(self, image):
        self.image = image


def test_json_frame_bytes_match_jax_viewer():
    """Same scene, weights and request through both viewers: the port's bytes
    equal the JAX viewer's, except that truncation at a float boundary may move
    a byte by 1 (at most 0.1% of them)."""
    W = H = 64
    p, s = ge._synthetic_scene(n=300, n_sky=40)
    jm = JMLPNet()
    key = jax.random.PRNGKey(0)
    mlp_params = jax.jit(lambda k: init_mlp(k, jm))(key)   # flax's init op by op takes ~4 s
    emb = init_embeddings(jax.random.fold_in(key, 1), 2)

    jhost = _Host()
    jhost.W, jhost.H, jhost.cfg, jhost.mlp = W, H, JConfig(), jm
    jhost.bg_color = jnp.zeros(3, jnp.float32)
    jhost.rcfg = JRasterizerConfig(width=W, height=H, max_dup=1 << 13, lmax_per_tile=512,
                                   tile_chunk=4)
    jhost.state = TrainState({"gaussians": p, "mlp": mlp_params, "embeddings": emb},
                             s, None, jnp.asarray(0))

    tm = MLPNet()
    tm.load_state_dict(convert.mlp_state_dict_from_flax(jax.device_get(mlp_params)))
    gp, gs = convert.gaussians_from_numpy({k: np.asarray(v) for k, v in p._asdict().items()},
                                          {k: np.asarray(v) for k, v in s._asdict().items()})
    thost = _Host()
    thost.W, thost.H, thost.cfg, thost.mlp = W, H, Config(), tm
    thost.bg_color = torch.zeros(3)
    thost.rcfg = trasterize.RasterizerConfig(width=W, height=H, max_dup=1 << 13)
    thost.state = viewer.ServeState(gp, gs, convert.embeddings_from_numpy(emb))

    a = np.deg2rad(5.0)
    view = np.eye(4, dtype=np.float32)
    view[0, 0], view[0, 2], view[2, 0], view[2, 2] = np.cos(a), np.sin(a), -np.sin(a), np.cos(a)
    fov = 2 * float(np.arctan(np.tan(np.deg2rad(30.0))))
    req = {"viewmat": view.tolist(), "fovx": fov, "fovy": fov, "width": W, "height": H,
           "train": True, "fix_sky": False, "embedding_index": 1}

    # Compile the JAX viewer's frame once outside the socket round trip, so the
    # round trip's waits do not race the compile.
    warm = _Capture()
    jviewer._serve_frame(warm, jhost, req)
    jserver = jviewer.ViewerServer(port=0, protocol="json")
    tserver = viewer.ViewerServer(port=0, protocol="json", device="cpu")
    try:
        want = _json_frame(jserver, jviewer.handle_viewer_request, jhost, req)
        got = _json_frame(tserver, viewer.handle_viewer_request, thost, req)
    finally:
        jserver.close_conn()
        jserver.listener.close()
        tserver.close()
    assert want == np.asarray(warm.image).tobytes()
    assert len(got) == len(want) == W * H * 3
    assert int(tserver.last_aux.overflow) == 0
    diff = np.abs(np.frombuffer(got, np.uint8).astype(int) - np.frombuffer(want, np.uint8))
    assert np.frombuffer(want, np.uint8).max() > 0
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3, (diff.max(), (diff > 0).mean())


def test_sibr_socket_roundtrip():
    server = viewer.ViewerServer(port=0, protocol="sibr", verify="/data/scene", device="cpu")
    try:
        client = _connect(server.port)
        deadline = time.time() + 30
        while not server.try_connect():
            assert time.time() < deadline
            time.sleep(0.01)
        msg = _sibr_msg(np.random.RandomState(3), 8, 4)
        payload = json.dumps(msg).encode()
        client.sendall(struct.pack("<I", len(payload)) + payload)
        req = None
        while req is None:
            assert time.time() < deadline
            req = server.receive()
        assert req["width"] == 8 and req["height"] == 4
        np.testing.assert_array_equal(req["viewmat"], viewer._normalize_sibr(msg)["viewmat"])
        img = np.linspace(0, 1, 4 * 8 * 3, dtype=np.float32).reshape(4, 8, 3)
        server.send_image(img)
        assert _recv_exact(client, 4 * 8 * 3) == (np.clip(img, 0, 1) * 255).astype(np.uint8).tobytes()
        (vlen,) = struct.unpack("<I", _recv_exact(client, 4))
        assert _recv_exact(client, vlen) == b"/data/scene"
        server.send_image(None)          # heartbeat reply: verify string only
        (vlen,) = struct.unpack("<I", _recv_exact(client, 4))
        assert _recv_exact(client, vlen) == b"/data/scene"
        client.close()
    finally:
        server.close()


def test_send_image_waits_for_a_slow_client():
    """A frame larger than the socket buffers reaches a client that starts
    reading late: the connection, non-blocking between requests, blocks while
    it sends instead of dropping the client."""
    server = viewer.ViewerServer(port=0, protocol="json", device="cpu")
    client = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    try:
        client.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 1 << 14)
        client.connect(("127.0.0.1", server.port))
        deadline = time.time() + 30
        while not server.try_connect():
            assert time.time() < deadline
            time.sleep(0.01)
        server.conn.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF, 1 << 14)
        img = np.random.RandomState(0).randint(0, 256, (400, 400, 3)).astype(np.uint8)
        got = []

        def read_late():
            time.sleep(0.3)
            (n,) = struct.unpack("<I", _recv_exact(client, 4))
            got.append(_recv_exact(client, n))

        reader = threading.Thread(target=read_late)
        reader.start()
        server.send_image(img)
        reader.join(30)
        assert not reader.is_alive()
        assert server.conn is not None, "server dropped a slow client"
        assert got == [img.tobytes()]
    finally:
        client.close()
        server.close()


def test_entry_points_run_on_cuda_by_default():
    """Without CUDA, an entry point not given device="cpu" raises."""
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is valid here")
    p, s = synthetic.synthetic_scene(n=20, n_sky=4)
    cam = synthetic.camera(16, 16)
    rcfg = trasterize.RasterizerConfig(width=16, height=16, max_dup=1 << 10)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        viewer.ViewerServer(port=0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        renderer.render_rgb(p, s, torch.zeros(25, 3), torch.zeros(1, 4, 3), cam, rcfg,
                            torch.zeros(3))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        trasterize.rasterize(p.xyz, torch.exp(p.scaling), p.rotation, torch.sigmoid(p.opacity),
                             torch.ones(24, 3), torch.zeros(3), cam, rcfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        light_cubemap.load_hdr_cubemap("envmap.hdr")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tune.objective(["scene"], {}, 1, "out")


def test_import_hygiene():
    """Every module of the port, chip_smoke and compositor_ab import no JAX,
    flax, optax or JAX package module, and import without nvcc or a GPU."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import relightable3dgaussians_w_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "import chip_smoke, compositor_ab\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0].startswith(('jax', 'flax', 'optax'))\n"
        "             or k.startswith('relightable3dgaussians_w_tpu'))\n"
        "assert not bad, bad\n"
        "for m in ('ops.cuda.tile_composite', 'ops.cuda.segment_sum', 'train_step',\n"
        "          'utils.losses', 'pretrain', 'ops.bsdf', 'models.light_cubemap', 'utils.hdr',\n"
        "          'cli.convert', 'cli.tune'):\n"
        "    assert 'relightable3dgaussians_w_torch.' + m in names, m\n"
        "print(len(names))\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 15
