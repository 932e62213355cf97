"""The port's profiler ranges, on the CPU.

One served frame through `viewer.handle_viewer_request` (a paused client: one
frame, one wait, then a heartbeat) into a ViewerServer whose connection is a
sink, and three iterations of `Relightable3DGWTrainer.train` on
tests/test_trainer_e2e.py's dataset (2 views, 32x32), each under `torch.profiler`: every range
the viewer, the trainer loop, the MLP, the shading and the sort open appears
as often as the work runs, nested where the profile's readers expect it, and
the frame's bytes and the steps' losses and parameters are the same bits with
the profiler and without.
"""

import json

import numpy as np
import pytest
import torch

from relightable3dgaussians_w_torch import config, trainer, viewer
from relightable3dgaussians_w_torch.scripts.serve_demo import build_host, yaw

from test_trainer_e2e import make_dataset
import _torch_threads

_torch_threads.share_cores()

FRAME = "test.serve_frame"   # the test's own range around the served frame
ITERATIONS = 3


def _profiled(fn):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, list(prof.events())


def _named(events, name):
    return sorted((e for e in events if e.name == name), key=lambda e: e.time_range.start)


def _ancestors(e):
    names = []
    while e.cpu_parent is not None:
        e = e.cpu_parent
        names.append(e.name)
    return names


class _SinkConn:
    """A connected socket that keeps what is sent."""

    def __init__(self):
        self.sent = []

    def settimeout(self, t):
        pass

    def sendall(self, data):
        self.sent.append(bytes(data))

    def close(self):
        pass


@pytest.fixture(scope="module")
def host():
    h, _, _ = build_host(n=500, res=32, device="cpu")
    return h


def _serve_once(host, monkeypatch):
    """A paused request, one empty poll (the loop's wait), then a heartbeat
    that closes the connection. Returns the bytes sent."""
    server = viewer.ViewerServer(port=0, protocol="json", device="cpu")
    sink = server.conn = _SinkConn()
    fov = 2 * float(np.arctan(np.tan(np.deg2rad(30.0))))
    req = {"viewmat": yaw(4.0).tolist(), "fovx": fov, "fovy": fov, "width": host.W,
           "height": host.H, "train": False, "fix_sky": False, "embedding_index": 1}

    def heartbeat():
        server.conn = None
        return {"width": 0, "height": 0, "train": True}

    script = iter([lambda: req, lambda: None, heartbeat])
    monkeypatch.setattr(server, "receive", lambda: next(script)())
    serve_frame = viewer._serve_frame

    def framed(*a):
        with torch.profiler.record_function(FRAME):
            serve_frame(*a)

    monkeypatch.setattr(viewer, "_serve_frame", framed)
    try:
        assert viewer.handle_viewer_request(server, host)
    finally:
        monkeypatch.setattr(viewer, "_serve_frame", serve_frame)
        server.close()
    assert len(sink.sent) == 1
    return sink.sent[0]


def test_served_frame_ranges(host, monkeypatch):
    plain = _serve_once(host, monkeypatch)
    traced, events = _profiled(lambda: _serve_once(host, monkeypatch))
    assert traced == plain and len(plain) == 4 + host.W * host.H * 3
    assert len(set(plain[4:])) > 1

    counts = {n: len(_named(events, n)) for n in (
        FRAME, "viewer.request", "viewer.to_host", "viewer.send", "viewer.wait", "nets.mlp",
        "renderer.shading", "binning.sort", "rasterize.binning")}
    # two sends: the frame's, and the heartbeat's (which sends nothing on json)
    assert counts == {FRAME: 1, "viewer.request": 1, "viewer.to_host": 1, "viewer.send": 2,
                      "viewer.wait": 1, "nets.mlp": 1, "renderer.shading": 1,
                      "binning.sort": 1, "rasterize.binning": 1}
    for name in ("viewer.request", "viewer.to_host", "nets.mlp", "renderer.shading",
                 "binning.sort"):
        assert FRAME in _ancestors(_named(events, name)[0]), name
    frame_send, heartbeat_send = _named(events, "viewer.send")
    assert FRAME in _ancestors(frame_send) and FRAME not in _ancestors(heartbeat_send)
    assert FRAME not in _ancestors(_named(events, "viewer.wait")[0])
    assert "rasterize.binning" in _ancestors(_named(events, "binning.sort")[0])
    # the MLP and the shading run after the request's parse and before the
    # frame comes to the host
    request, to_host = _named(events, "viewer.request")[0], _named(events, "viewer.to_host")[0]
    for name in ("nets.mlp", "renderer.shading", "binning.sort"):
        e = _named(events, name)[0]
        assert request.time_range.end <= e.time_range.start
        assert e.time_range.end <= to_host.time_range.start


def _train(tmp_path, tag):
    data = tmp_path / "scene"
    if not data.exists():
        make_dataset(str(data), n_views=2, size=32)
    cfg = config.Config()
    cfg.dataset.source_path, cfg.dataset.model_path = str(data), str(tmp_path / tag)
    cfg.optimizer.densify_from_iter = 10
    cfg.optimizer.reg_normal_from_iter = 0
    cfg.runtime.pool_capacity = 4096
    cfg.runtime.max_dup = 0
    tr = trainer.Relightable3DGWTrainer(cfg, device="cpu")
    # the loop's last iteration evaluates and saves; neither is traced here
    tr.evaluate_report = lambda it: None
    tr.save = lambda it: None
    return tr


def _run(tr):
    tr.train(iterations=ITERATIONS, save_iterations=(), log_every=1, test_iterations=())
    with open(tr.log_path) as f:
        return [r["loss"] for r in map(json.loads, f) if "loss" in r]


def test_trainer_loop_ranges(tmp_path):
    plain_tr, traced_tr = _train(tmp_path, "plain"), _train(tmp_path, "traced")
    plain = _run(plain_tr)
    traced, events = _profiled(lambda: _run(traced_tr))
    assert len(plain) == ITERATIONS and traced == plain
    for k, v in plain_tr.state.params["gaussians"]._asdict().items():
        assert torch.equal(v, traced_tr.state.params["gaussians"]._asdict()[k]), k
    for k, v in plain_tr.state.params["mlp"].items():
        assert torch.equal(v, traced_tr.state.params["mlp"][k]), k

    iters = _named(events, "trainer.iteration")
    reads = _named(events, "trainer.overflow_read")
    assert len(iters) == ITERATIONS and len(reads) == ITERATIONS - 1
    # the first iteration has no previous step to read
    for r in reads:
        assert r.cpu_parent.name == "trainer.iteration"
    assert [r.cpu_parent.time_range.start for r in reads] == [
        i.time_range.start for i in iters[1:]]
    for name in ("train_step.leaf_inputs", "nets.mlp", "renderer.shading", "binning.sort"):
        assert len(_named(events, name)) == ITERATIONS, name
    for name in ("nets.mlp", "renderer.shading"):
        for e in _named(events, name):
            assert "train_step.leaf_inputs" in _ancestors(e), name
    for e in _named(events, "binning.sort"):
        assert "rasterize.binning" in _ancestors(e)
        assert "trainer.iteration" in _ancestors(e)
