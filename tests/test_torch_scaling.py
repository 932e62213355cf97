"""The port's data-parallel scaling harness (`scripts/bench_scaling.py`) on the CPU.

Its inputs against the JAX recipe (`scripts/bench_scaling.py` over
`__graft_entry__._synthetic_scene` / `_camera`): the scene, the camera and the
RandomState(0) ground truth of the n = 1 and n = 2 runs, bitwise (the sky
rows' angles, torch's and XLA's arccos / arctan2 of the same draws, within 2
ulp). One run of
the harness itself, 2 gloo ranks at 2,000 Gaussians / 32² / 2 timed steps,
started by a module fixture so it runs while the references are built: its
JSON line (n = 1 efficiency exactly 1.0, zero overflow, finite losses) and
its first step's per-image losses against the port's single-device forward
loss on the same inputs (1e-5 relative). Asking for more NCCL ranks than
cards raises before any rank starts.
"""

import json
import math
import subprocess
import threading

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import __graft_entry__ as graft

from relightable3dgaussians_w_torch import train_step as TS
from relightable3dgaussians_w_torch.scripts import bench_scaling as BS

import _torch_threads

_torch_threads.share_cores()

N_GAUSS, RES, ITERS, RANKS = 2000, 32, 2, 2
JOIN_S = 300
LOSS_TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def harness():
    """The 2-rank gloo run, started in a thread now and joined by `result`."""
    box = {"lines": []}

    def go():
        try:
            box["out"] = BS.run(N_GAUSS, RES, ITERS, ranks=RANKS, device="cpu", timeout_s=JOIN_S,
                                log=box["lines"].append)
        except Exception as e:   # re-raised in the test thread by `result`
            box["error"] = e

    thread = threading.Thread(target=go, daemon=True)
    thread.start()
    box["thread"] = thread
    return box


@pytest.fixture(scope="module")
def result(harness):
    harness["thread"].join(JOIN_S + 60)
    assert not harness["thread"].is_alive(), "the harness run did not finish"
    if "error" in harness:
        raise harness["error"]
    return harness["out"], harness["lines"]


def jax_recipe(res, n_gauss, ns):
    """The JAX script's scene, camera and ground truth per n, in its draw order."""
    params, state = graft._synthetic_scene(n=n_gauss, n_sky=BS.N_SKY, cap=int(n_gauss * 1.3))
    cam = graft._camera(res, res)
    rng = np.random.RandomState(0)
    gts = {n: np.asarray(jnp.asarray(rng.uniform(0, 1, (n, res, res, 3)), jnp.float32))
           for n in ns}
    return params, state, cam, gts


def test_inputs_match_the_jax_recipe():
    params, state, cam, gts = jax_recipe(RES, N_GAUSS, (1, 2))
    for n in (1, 2):
        s = BS.build(n, N_GAUSS, RES, device="cpu")
        got_p, got_s = s.state.params["gaussians"], s.state.gauss_state
        for k, v in params._asdict().items():
            if k == "sky_angles":   # torch's and XLA's arccos / arctan2 of the same draws
                np.testing.assert_array_max_ulp(got_p.sky_angles.numpy(), np.asarray(v), 2)
            else:
                np.testing.assert_array_equal(getattr(got_p, k).numpy(), np.asarray(v),
                                              err_msg=k)
        for k, v in state._asdict().items():
            np.testing.assert_array_equal(getattr(got_s, k).numpy(), np.asarray(v), err_msg=k)
        for i in range(n):
            for got, want in zip(s.batch.camera(i), cam):
                np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(s.batch.gt_image.numpy(), gts[n])
        assert s.batch.uid.tolist() == list(range(n)) and s.rcfg.max_dup == 1 << 16
        assert s.state.params["embeddings"].shape == (n, 32) and len(s.draws) == n
    assert BS.gt_images(4, RES).shape == (4, RES, RES, 3)
    with pytest.raises(ValueError):
        BS.gt_images(3, RES)


def test_two_rank_gloo_run(result):
    out, lines = result
    assert json.loads(lines[-1]) == json.loads(json.dumps(out))
    assert "shared_card" not in out and out["device"] == "cpu" and out["backend"] == "gloo"
    assert sorted(out["scaling"]) == [1, 2]
    one, two = out["scaling"][1], out["scaling"][2]
    assert one["efficiency"] == 1.0
    for n, e in out["scaling"].items():
        assert e["overflow"] == 0 and e["backend"] == "gloo" and e["ranks_per_card"] is None
        assert math.isfinite(e["loss"]) and math.isfinite(e["last_loss"])
        assert e["images_per_s"] > 0 and e["ms_per_step"] > 0 and len(e["first_losses"]) == n
        assert e["devices"] == ["cpu"] * n and e["card"] is None
    assert math.isclose(two["images_per_s"], 2e3 / two["ms_per_step"], rel_tol=1e-12)
    assert lines[0].startswith("devices=1:") and lines[1].startswith("devices=2:")


def test_first_losses_match_single_device(result):
    """Each image's loss in the first DP step equals the single-device forward
    loss of that image, from the same state and draws."""
    out, _ = result
    for n in (1, 2):
        s = BS.build(n, N_GAUSS, RES, device="cpu")
        with torch.no_grad():
            for i in range(n):
                want, _ = TS.forward_loss(s.state.params, s.state.gauss_state, None, s.mlp,
                                          s.batch.camera(i), s.batch.gt_image[i],
                                          s.batch.sky_mask[i], s.batch.occluders_mask[i], i,
                                          s.draws[i], s.state.step, s.cfg, s.rcfg, s.bg,
                                          device="cpu")
                got = out["scaling"][n]["first_losses"][i]
                assert abs(got - float(want)) <= LOSS_TOL * abs(float(want)), (n, i, got, want)


def test_refuses_more_nccl_ranks_than_cards(result, monkeypatch):
    """More NCCL ranks than cards raise before any rank starts: nothing falls
    back to gloo or to the CPU. (After the harness run: it patches the
    process-wide subprocess.Popen.)"""
    def no_spawn(*a, **k):
        raise AssertionError("a rank was started")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(subprocess, "Popen", no_spawn)
    with pytest.raises(ValueError, match="NCCL refuses two ranks on one card"):
        BS.run(N_GAUSS, RES, ITERS, ranks=2, device="cuda")
    with pytest.raises(ValueError, match="NCCL refuses"):
        BS.run(N_GAUSS, RES, ITERS, ranks=4, device="cuda", backend="nccl")
    with pytest.raises(ValueError, match="CPU"):
        BS.run(N_GAUSS, RES, ITERS, ranks=1, device="cpu", backend="nccl")
