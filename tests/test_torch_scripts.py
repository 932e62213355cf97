"""The port's user-facing scripts and packaging, on the CPU.

* `scripts/selfcheck_train.py`: the JAX self-check's set-up (built here with
  the JAX modules as its script builds it, at 32x32 and 2 views) and its
  draws go into `build_selfcheck`; the ground-truth views and 3 training steps
  are held against JAX's (loss and PSNR within 1e-4 relative, parameters
  within the gradient tolerance, max |delta| / max |ref| < 5e-3); the densify
  schedule, the gates, the CLI's exit code and the data-parallel leg.
* `scripts/serve_demo.py`: frames through the port's ViewerServer, the
  first one against a direct render, the entry budget against the JAX demo's
  sizing.
* `scripts/convert_lpips_weights.py`, `deploy/batch_relit3dgw_h100.sh` (with a
  stub interpreter) and `deploy/relit3dgw-h100.def`.
"""

import json
import os
import re
import stat
import subprocess
import sys
from functools import partial
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import __graft_entry__ as ge
from relightable3dgaussians_w_tpu.config import Config as JConfig
from relightable3dgaussians_w_tpu.models import gaussians as jG
from relightable3dgaussians_w_tpu.models.nets import (MLPNet as JMLPNet, init_embeddings,
                                                       init_mlp as jinit_mlp)
from relightable3dgaussians_w_tpu.ops.preprocess import preprocess as jpreprocess
from relightable3dgaussians_w_tpu.ops.rasterize import (CameraMatrices as JCameraMatrices,
                                                        RasterizerConfig as JRasterizerConfig)
from relightable3dgaussians_w_tpu.renderer import render as jrender
from relightable3dgaussians_w_tpu.train_step import (TrainState as JTrainState,
                                                     make_optimizer, make_train_fns)
from relightable3dgaussians_w_tpu.utils.graphics import projection_matrix as jprojection

from relightable3dgaussians_w_torch import convert, train_step as TS, viewer
from relightable3dgaussians_w_torch.models import lpips
from relightable3dgaussians_w_torch.scripts import convert_lpips_weights
from relightable3dgaussians_w_torch.scripts import selfcheck_train as SC
from relightable3dgaussians_w_torch.scripts import serve_demo
import _torch_threads

_torch_threads.share_cores()

REPO = Path(__file__).resolve().parents[1]
GRAD_TOL = 5e-3
RES, VIEWS, STEPS = 32, 2, 3
LMAX = 2048


def rel_err(got, want):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def check_image(got, want):
    """The JAX package's image tolerance: under 0.1% of values off by more
    than 1e-3, median error under 1e-5."""
    err = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    assert (err > 1e-3).mean() < 1e-3 and np.median(err) < 1e-5, (err.max(), np.median(err))


# ------------------------------------------------------------ self-check vs JAX


def jax_selfcheck(res, n_views, steps):
    """The JAX script's set-up (scripts/selfcheck_train.py:36-127, line for
    line, on the jnp path) and its first `steps` training steps. Returns the
    draws the port takes, the ground-truth views, each step's (view, key),
    loss and PSNR, and the final state.

    One change: the jnp compositor's static per-tile cap (`lmax_per_tile`,
    512 in the script) is raised to LMAX, above any tile's entry count here.
    The cap drops a tile's entries past it; the TPU kernel and the port have no
    such cap. At the script's 128x128 the scene puts at most 517 entries in a
    tile, at 32x32 up to 1,886."""
    rng = np.random.RandomState(0)
    rcfg = JRasterizerConfig(width=res, height=res, max_dup=1 << 17, max_tiles_per_gauss=0,
                             lmax_per_tile=LMAX, tile_chunk=8, use_pallas=False)
    n_gt, n_sky = 4000, 384
    pts = np.stack([rng.uniform(-1.5, 1.5, n_gt), rng.uniform(-1.5, 1.5, n_gt),
                    rng.uniform(2.0, 6.0, n_gt)], -1).astype(np.float32)
    gt_params, gt_state = jG.init_from_points(pts, np.full(n_gt, 0.004, np.float32),
                                              n_gt + n_sky)
    theta = rng.uniform(0.1, 1.4, n_sky)
    phi = rng.uniform(-1.4, 1.4, n_sky)
    R = 25.0
    sky_pts = np.stack([R * np.sin(theta) * np.sin(phi), -R * np.cos(theta),
                        4.0 + R * np.sin(theta) * np.cos(phi)], -1).astype(np.float32)
    gt_params, gt_state = jG.augment_with_sky(
        gt_params, gt_state, sky_pts, np.full(n_sky, 1.5, np.float32), R,
        np.array([0, 0, 4.0], np.float32))
    albedo = jax.random.normal(jax.random.PRNGKey(1), (n_gt, 3))
    gt_params = gt_params._replace(albedo=gt_params.albedo.at[:n_gt].set(albedo),
                                   opacity=gt_params.opacity.at[:n_gt].set(2.0))
    envl_base = rng.uniform(0.0, 0.6, (25, 3))
    envl_gts = [jnp.asarray(envl_base + rng.uniform(-0.12, 0.12, (25, 3)), jnp.float32)
                for _ in range(n_views)]
    sky_gt = jnp.asarray(rng.uniform(-0.2, 0.2, (1, 4, 3)), jnp.float32)

    def make_cam(angle):
        fov = np.deg2rad(60)
        c = np.array([4.0 * np.sin(angle), 0.0, 4.0 - 4.0 * np.cos(angle)])
        fwd = np.array([0, 0, 4.0]) - c
        fwd /= np.linalg.norm(fwd)
        right = np.cross([0, 1, 0], fwd)
        right /= np.linalg.norm(right)
        up = np.cross(fwd, right)
        w2c = np.eye(4, dtype=np.float32)
        w2c[:3, :3] = np.stack([right, up, fwd], 0)
        w2c[:3, 3] = -w2c[:3, :3] @ c
        proj = jprojection(0.01, 100.0, fov, fov)
        return JCameraMatrices(
            viewmat=jnp.asarray(w2c), projmat=jnp.asarray(proj @ w2c),
            campos=jnp.asarray(c, jnp.float32),
            tan_fovx=jnp.float32(np.tan(fov / 2)), tan_fovy=jnp.float32(np.tan(fov / 2)))

    cams = [make_cam(a) for a in np.linspace(-0.5, 0.5, n_views)]
    bg = jnp.zeros(3)
    sky_mask = jnp.ones((res, res))
    render_gt = jax.jit(lambda cam, envl: jnp.clip(jrender(
        gt_params, gt_state, envl, sky_gt, cam, rcfg, bg, sky_mask, debug=False).render, 0, 1))
    gts = [render_gt(c, e) for c, e in zip(cams, envl_gts)]

    cfg = JConfig()
    cfg.optimizer.reg_normal_from_iter = 400
    cfg.optimizer.densify_from_iter = 100
    cfg.optimizer.densification_interval = 100
    cfg.optimizer.densify_until_iter = steps // 2
    cfg.optimizer.opacity_reset_interval = 10**9
    n0 = 2000
    pts0 = np.stack([rng.uniform(-1.5, 1.5, n0), rng.uniform(-1.5, 1.5, n0),
                     rng.uniform(2.0, 6.0, n0)], -1).astype(np.float32)
    params_g, gstate = jG.init_from_points(pts0, np.full(n0, 4e-4, np.float32), 32768)
    mlp = JMLPNet()
    k = jax.random.PRNGKey(0)
    mlp_params = jax.jit(lambda key: jinit_mlp(key, mlp))(k)   # flax's init op by op is slow
    params = {"gaussians": params_g, "mlp": mlp_params,
              "embeddings": init_embeddings(jax.random.fold_in(k, 1), n_views)}
    state = JTrainState(params, gstate, make_optimizer().init(params), jnp.asarray(0))
    draws = {"gt_albedo": np.asarray(albedo),
             "mlp": convert.mlp_state_dict_from_flax(jax.device_get(mlp_params)),
             "embeddings": np.asarray(params["embeddings"])}

    fns = make_train_fns(mlp, cfg, rcfg)
    occ = jnp.ones((res, res))
    key = jax.random.PRNGKey(7)
    steps_out, states = [], [jax.device_get(state)]
    for _ in range(steps):
        vi = rng.randint(n_views)
        key, ks = jax.random.split(key)
        state, aux = fns.train_step(state, cams[vi], gts[vi], sky_mask, occ, jnp.asarray(vi),
                                    ks, bg)
        steps_out.append(dict(view=int(vi), key=ks, loss=float(aux.loss),
                              psnr=float(aux.psnr), overflow=int(aux.overflow)))
        states.append(jax.device_get(state))
    return dict(draws=draws, gts=[np.asarray(g) for g in gts], steps=steps_out,
                states=states, mlp=mlp, mlp_params=mlp_params)


def port_state(j):
    """A JAX TrainState (numpy) as the port's."""
    return convert.train_state_from_jax(j.params, j.gauss_state, j.opt_state.mu,
                                        j.opt_state.nu, j.opt_state.count, j.step)


def jax_step_draws(mlp, mlp_params, embedding, key):
    """A JAX step key's draws, as the JAX step makes them
    (train_step.make_leaf_inputs, utils/losses.envl_sh_loss): envlight noise,
    the dropout keep-mask (read from the flax Dropout's output) and the R+
    sample directions."""
    k_noise, k_drop, k_envl = jax.random.split(key, 3)
    _, inter = mlp.apply({"params": mlp_params}, embedding[None], deterministic=False,
                         rngs={"dropout": k_drop}, capture_intermediates=True,
                         mutable=["intermediates"])
    keep = inter["intermediates"]["Dropout_0"]["__call__"][0] != 0
    return (jax.random.normal(k_noise, (25, 3)) * 0.025, keep,
            jax.random.uniform(k_envl, (10, 3), minval=-1.0, maxval=1.0))


@pytest.fixture(scope="module")
def parity():
    ref = jax_selfcheck(RES, VIEWS, STEPS)
    step_draws = jax.jit(partial(jax_step_draws, ref["mlp"]))
    emb0 = jnp.asarray(ref["draws"]["embeddings"][0])
    draws = [TS.StepDraws(*[torch.as_tensor(np.array(a)) for a in
                            step_draws(ref["mlp_params"], emb0, s["key"])])
             for s in ref["steps"]]
    setup = SC.build_selfcheck(RES, VIEWS, "cpu", torch.Generator().manual_seed(0),
                               draws=ref["draws"])
    gts = [g.clone() for g in setup.gts]
    rng_state = setup.rng.get_state()
    seen = []
    run = SC.run_selfcheck(setup, STEPS, step_draws=lambda it: draws[it - 1],
                           on_step=lambda it, aux: seen.append(aux), log=lambda *_: None)
    # Each step again from JAX's state before it (the view order advanced to it).
    stepped = []
    for k in range(STEPS):
        rng = np.random.RandomState()
        rng.set_state(rng_state)
        rng.randint(VIEWS, size=k)
        one = SC.run_selfcheck(setup._replace(state=port_state(ref["states"][k]), rng=rng), 1,
                               step_draws=lambda it, k=k: draws[k], log=lambda *_: None)
        stepped.append(one.state)
    return dict(ref=ref, gts=gts, seen=seen, run=run, stepped=stepped)


def test_selfcheck_ground_truth_matches_jax(parity):
    for got, want in zip(parity["gts"], parity["ref"]["gts"]):
        assert float(np.asarray(want).std()) > 0.05
        check_image(got.numpy(), want)


def check_state(got, want):
    """Parameters, Adam moments and densification statistics within the
    gradient tolerance (each leaf that is not all zeros in JAX's state)."""
    for g, w in zip(TS.tree_leaves((got.params, got.opt_state.mu, got.opt_state.nu)),
                    TS.tree_leaves((want.params, want.opt_state.mu, want.opt_state.nu))):
        if float(w.abs().max()) > 0:
            assert rel_err(g, w) < GRAD_TOL, (g.shape, rel_err(g, w))
    for name in ("xyz_grad_accum", "denom", "max_radii2d"):
        assert float(getattr(want.gauss_state, name).abs().max()) > 0, name
        assert rel_err(getattr(got.gauss_state, name),
                       getattr(want.gauss_state, name)) < GRAD_TOL, name
    assert torch.equal(got.gauss_state.alive, want.gauss_state.alive)
    assert int(got.opt_state.count) == int(want.opt_state.count)
    assert int(got.step) == int(want.step)


def test_selfcheck_steps_match_jax(parity):
    """run_selfcheck's first steps against the JAX script's: every step's loss
    and PSNR within 1e-4 relative. The parameters are held to the gradient
    tolerance after each step taken from JAX's state before it. Run on, the
    two runs' states stay within ~1e-5 for two steps; at the third a view is
    seen for the first time, Adam's first move on a row is lr x sign(its
    gradient), and where the L1 term's sign flips on a pixel between the two
    slightly different states, a few low-gradient rows move by lr the other
    way (opacity 2.8e-2 off at 32x32, while the gradients taken from one state
    agree to ~1e-4)."""
    ref, run = parity["ref"], parity["run"]
    assert len(parity["seen"]) == STEPS
    for aux, want in zip(parity["seen"], ref["steps"]):
        assert int(aux.overflow) == want["overflow"] == 0
        assert abs(float(aux.loss) - want["loss"]) <= 1e-4 * abs(want["loss"])
        assert abs(float(aux.psnr) - want["psnr"]) <= 1e-4 * abs(want["psnr"])
    assert run.trajectory == [(1, float(parity["seen"][0].psnr))]
    assert int(run.state.step) == STEPS and run.overflow == 0
    for k, got in enumerate(parity["stepped"]):
        check_state(got, port_state(ref["states"][k + 1]))


# ------------------------------------------------------------ self-check schedule and gates


@pytest.mark.parametrize("iters,due", [(1500, [200, 300, 400, 500, 600, 700]),
                                       (1000, [200, 300, 400]), (201, [])])
def test_selfcheck_densify_schedule(monkeypatch, iters, due):
    """Densify runs after the step of every 100th iteration strictly between
    100 and iters // 2, as the JAX script's loop does; the PSNR is recorded at
    iteration 1 and every 100."""
    calls = []
    zero = torch.zeros(())
    aux = SimpleNamespace(loss=zero, psnr=zero, overflow=torch.zeros((), dtype=torch.int32),
                          num_alive=zero)
    monkeypatch.setattr(SC.TS, "train_step", lambda state, *a, **k: (
        calls.append("step") or (state + 1, aux)))
    monkeypatch.setattr(SC.TS, "densify_step", lambda state, *a, **k: (
        calls.append(int(state)) or (state, None)))
    setup = SimpleNamespace(cfg=SC.selfcheck_config(), device=torch.device("cpu"),
                            rng=np.random.RandomState(0), n_views=2, state=0,
                            cams=[None] * 2, gts=[None] * 2, ones=None, bg=None, mlp=None,
                            rcfg=None, generator=None)
    run = SC.run_selfcheck(setup, iters, step_draws=lambda it: None, log=lambda *_: None)
    assert [c for c in calls if c != "step"] == due
    assert calls.count("step") == run.state == iters
    assert [it for it, _ in run.trajectory] == [1] + list(range(100, iters + 1, 100))


def _trajectory(first, body, tail):
    """Checkpoints at 1, 100, ..., 1500: `first`, then `body` up to 1200, then
    `tail` for 1300-1500 (the last 300 iterations)."""
    return [(1, first)] + [(it, body) for it in range(100, 1201, 100)] + \
        [(it, tail) for it in (1300, 1400, 1500)]


@pytest.mark.parametrize("traj,ok", [
    (_trajectory(9.0, 25.0, 22.0), True),
    (_trajectory(9.0, 20.9, 20.5), False),    # best under 21
    (_trajectory(16.0, 21.5, 21.0), False),   # gain 5.5 dB
    (_trajectory(9.0, 30.0, 19.9), False),    # tail mean under 20
])
def test_selfcheck_gates(monkeypatch, traj, ok):
    for name in ("SELFCHECK_MIN_PSNR", "SELFCHECK_MIN_GAIN", "SELFCHECK_MIN_TAIL"):
        monkeypatch.delenv(name, raising=False)
    g = SC.gates(traj, 1500)
    assert (g.first, g.best) == (traj[0][1], max(p for _, p in traj))
    assert g.tail_mean == pytest.approx(np.mean([p for _, p in traj[-3:]]))
    assert g.ok == ok and (g.min_psnr, g.min_gain, g.min_tail) == (21.0, 6.0, 20.0)
    # Each limit comes from its variable.
    monkeypatch.setenv("SELFCHECK_MIN_PSNR", "0")
    monkeypatch.setenv("SELFCHECK_MIN_GAIN", "0")
    monkeypatch.setenv("SELFCHECK_MIN_TAIL", "0")
    assert SC.gates(traj, 1500).ok
    for name in ("SELFCHECK_MIN_PSNR", "SELFCHECK_MIN_GAIN", "SELFCHECK_MIN_TAIL"):
        monkeypatch.setenv(name, "99")
        assert not SC.gates(traj, 1500).ok, name
        monkeypatch.setenv(name, "0")
    # No checkpoint in the last 300 iterations: the tail is the first.
    assert SC.gates([(1, 8.0), (100, 30.0)], 1500).tail_mean == 8.0


def test_selfcheck_cli_fails_its_gate(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("SELFCHECK_MIN_PSNR", "99")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SC.main(["2", "32", "2"])                 # the card, unless asked for the CPU
    assert SC.main(["2", "32", "2", "--device=cpu"]) == 1
    lines = [json.loads(x) for x in
             (tmp_path / "build" / "selfcheck" / "selfcheck.jsonl").read_text().splitlines()]
    assert [x["iter"] for x in lines[:-1]] == [1]
    summary = lines[-1]
    assert (summary["iters"], summary["res"], summary["views"]) == (2, 32, 2)
    assert summary["dp_step"] is False and summary["device"] == "cpu"
    assert summary["ok"] is False and summary["overflow"] == 0
    assert summary["first"] == summary["best"] == lines[0]["psnr"] > 5


def test_selfcheck_dp_leg_equals_plain_steps():
    """Two steps through make_dp_train_step on a 1 x 1 mesh (a one-rank gloo
    group, opened and closed by the run) against two plain steps, same
    draws."""
    gen = torch.Generator().manual_seed(3)
    cfg = SC.selfcheck_config()
    runs = {}
    for dp in (False, True):
        setup = SC.build_selfcheck(RES, VIEWS, "cpu", torch.Generator().manual_seed(0))
        draws = [TS.make_draws(torch.Generator().manual_seed(it), setup.mlp, cfg)
                 for it in range(2)]
        seen = []
        runs[dp] = (SC.run_selfcheck(setup, 2, dp=dp, step_draws=lambda it: draws[it - 1],
                                     on_step=lambda it, aux: seen.append(aux),
                                     log=lambda *_: None), seen)
        assert not torch.distributed.is_initialized()
    (plain, p_aux), (dp, d_aux) = runs[False], runs[True]
    for a, b in zip(p_aux, d_aux):
        assert abs(float(a.loss) - float(b.loss)) <= 1e-5 * abs(float(a.loss))
        assert abs(float(a.psnr) - float(b.psnr)) <= 1e-5 * abs(float(a.psnr))
    assert plain.trajectory == dp.trajectory
    for got, want in zip(TS.tree_leaves((dp.state.params, dp.state.gauss_state)),
                         TS.tree_leaves((plain.state.params, plain.state.gauss_state))):
        if want.dtype.is_floating_point:
            assert rel_err(got, want) < 1e-5
        else:
            assert torch.equal(got, want)
    assert int(dp.state.step) == int(plain.state.step) == 2


# ------------------------------------------------------------ serving demo


def test_serve_demo(tmp_path, monkeypatch):
    n, res, frames = 2000, 64, 3
    served = []
    serve_frames = serve_demo.serve_frames
    monkeypatch.setattr(serve_demo, "serve_frames", lambda *a, **k: served.append(
        serve_frames(*a, **k)) or served[-1])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve_demo.main([str(n), str(res), str(frames)])
    out = tmp_path / "serve.json"
    assert serve_demo.main([str(n), str(res), str(frames), "--device=cpu", f"--out={out}"]) == 0
    record = json.loads(out.read_text())
    result, per_frame = served[0]
    assert len(result) == frames and all(len(b) == res * res * 3 for _, b in result)
    assert record["frames"] == frames and record["resolution"] == [res, res]
    assert record["max_overflow"] == 0 and record["backend"] == "cpu"
    assert all(f["overflow"] == 0 and f["entries"] > 0 for f in per_frame)

    # The first frame against a direct render of its camera (the json request
    # carries the fov, not tan(fov / 2): a few bytes 1 off).
    host, cam0, demand = serve_demo.build_host(n, res, device="cpu")
    cam = serve_demo.synthetic.camera(res, res, viewmat=serve_demo.yaw(-10.0))
    m = host.cfg.model
    with torch.inference_mode():
        envl, sky = host.mlp(host.state.embeddings[0][None])
        want, _ = viewer._frame_u8(host.state, envl[0], sky, cam, host.bg_color, host.rcfg, 
                                   m.envlight_sh_degree, m.sky_sh_degree, m.specular,
                                   m.fix_sky, "cpu")
    diff = np.abs(np.frombuffer(result[0][1], np.uint8).astype(int) - want.numpy().ravel())
    assert want.numpy().max() > 0
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3, (diff.max(), (diff > 0).mean())

    # The entry budget: the JAX demo's sizing (scripts/serve_demo.py _build_shim).
    d2 = 0.008 * (10_000 / n) ** (2.0 / 3.0)
    jp, js = ge._synthetic_scene(n=n, n_sky=max(n // 100, 500), d2=d2)
    jcam = ge._camera(res, res)

    @jax.jit
    def count(viewmat):
        opa = jG.get_opacity(jp, js)[:, 0] * js.alive.astype(jnp.float32)
        pre = jpreprocess(jG.get_xyz(jp, js), jG.get_scaling(jp), jG.get_rotation(jp), viewmat,
                          jcam.projmat @ viewmat, jcam.tan_fovx, jcam.tan_fovy, res, res, 16,
                          opacities=opa, skip_alpha=1.0 / 255.0)
        return jnp.sum(pre.tiles_touched)

    j_demand = max(int(count(jnp.asarray(serve_demo.yaw(d)))) for d in (-10.0, 0.0, 10.0))
    j_max_dup = min(max(((int(j_demand * 1.10) + 4095) // 4096) * 4096, 4096), 1 << 23)
    assert demand == j_demand
    assert record["max_dup"] == host.rcfg.max_dup == j_max_dup


# ------------------------------------------------------------ packaging


STUB_PYTHON = """#!{python}
import json, os, sys
args = sys.argv[1:]
kw = dict(a[2:].split("=", 1) for a in args if a.startswith("--") and "=" in a)
data = os.path.join(kw["data_root"], kw["scenes"])
with open(os.environ["STUB_LOG"], "w") as f:
    json.dump({{"args": args, "staged": sorted(os.listdir(data)),
               "test_configs": sorted(os.listdir(os.path.join(kw["data_root"], "test_configs"))),
               "pythonpath": os.environ.get("PYTHONPATH", "").split(os.pathsep)[0]}}, f)
out = os.path.join(kw["output"], kw["scenes"])
os.makedirs(out, exist_ok=True)
with open(os.path.join(out, "partial.txt"), "w") as f:
    f.write("partial")
sys.exit(int(os.environ["STUB_RC"]))
"""


@pytest.mark.parametrize("rc", [0, 1])
def test_batch_job(tmp_path, rc):
    """deploy/batch_relit3dgw_h100.sh under plain bash with a stub `python3`:
    the scene and its test config staged to scratch, the full_eval command and
    the overrides passed on, whatever output exists copied back (also when
    the run fails), scratch removed, and the run's exit code returned."""
    bin_dir, data, out, scratch = (tmp_path / d for d in ("bin", "data", "out", "scratch"))
    for d in (bin_dir, data / "lk2" / "images", data / "test_configs" / "lk2", scratch):
        d.mkdir(parents=True)
    (data / "lk2" / "images" / "a.png").write_bytes(b"png")
    (data / "lk2" / "points.ply").write_bytes(b"ply")
    (data / "test_configs" / "lk2" / "test_config.json").write_text("{}")
    stub = bin_dir / "python3"
    stub.write_text(STUB_PYTHON.format(python=sys.executable))
    stub.chmod(stub.stat().st_mode | stat.S_IEXEC)
    log = tmp_path / "stub.json"
    env = {k: v for k, v in os.environ.items() if not k.startswith(("SLURM_", "PYTHON"))}
    env.update(PATH=f"{bin_dir}{os.pathsep}{os.environ['PATH']}", DATA_ROOT=str(data),
               OUT_ROOT=str(out), TMPDIR=str(scratch), STUB_LOG=str(log), STUB_RC=str(rc))
    proc = subprocess.run(["bash", str(REPO / "deploy" / "batch_relit3dgw_h100.sh"), "lk2",
                           "optimizer.iterations=2", "runtime.seed=3"], env=env,
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode == rc, proc.stderr
    called = json.loads(log.read_text())
    work = called["args"][2].split("=", 1)[1].rsplit("/data", 1)[0]
    assert work.startswith(str(scratch))
    assert called["args"] == ["-m", "relightable3dgaussians_w_torch.cli.full_eval",
                              f"--data_root={work}/data", f"--output={work}/out",
                              "--scenes=lk2", "optimizer.iterations=2", "runtime.seed=3"]
    assert called["staged"] == ["images", "points.ply"] and called["test_configs"] == ["lk2"]
    assert called["pythonpath"] == str(REPO)
    assert (out / "lk2" / "partial.txt").read_text() == "partial"
    assert os.listdir(scratch) == []

    # A scene that is not there: no run, a failing exit code.
    log.unlink()
    proc = subprocess.run(["bash", str(REPO / "deploy" / "batch_relit3dgw_h100.sh"), "lwp"],
                          env=env, capture_output=True, text=True, timeout=60)
    assert proc.returncode != 0 and not log.exists()


def test_container_definition():
    """deploy/relit3dgw-h100.def: its runscript runs a port module that
    imports, %post installs no JAX and no package of finished kernels, and no
    section names JAX or the JAX package."""
    text = (REPO / "deploy" / "relit3dgw-h100.def").read_text()
    sections = {}
    name = "header"
    for line in text.splitlines():
        if line.startswith("%"):
            name = line.split()[0]
        elif not line.strip().startswith("#"):
            sections.setdefault(name, []).append(line)
    assert {"%files", "%post", "%environment", "%runscript"} <= set(sections)
    for name, lines in sections.items():
        body = "\n".join(lines)
        assert not re.search(r"\bjax\b|flax|optax|relightable3dgaussians_w_tpu", body), name
    runscript = "\n".join(sections["%runscript"])
    module = re.search(r"exec python -m ([\w.]+) \"\$@\"", runscript).group(1)
    assert module == "relightable3dgaussians_w_torch.cli.full_eval"
    assert callable(__import__(module, fromlist=["main"]).main)
    installed = set()
    for line in sections["%post"]:
        if "pip install" in line:
            installed |= {w for w in line.split("pip install", 1)[1].split()
                          if not w.startswith("-") and "://" not in w}
    assert installed == {"torch", "numpy", "scipy", "pillow", "msgpack", "pyyaml"}
    assert "ops.cuda import build" in "\n".join(sections["%post"])
    assert "PYTHONUNBUFFERED=1" in "\n".join(sections["%environment"])
    assert re.match(r"From: \S+cuda\S*devel", "\n".join(sections["header"]).split("Bootstrap")[1]
                    .split("\n", 1)[1].strip())


def test_lpips_converter(tmp_path, monkeypatch, capsys):
    assert convert_lpips_weights.main(["--print-schema"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == len(lpips.EXPECTED_SCHEMA)
    assert lines[0] == "feats.0.weight: float32 (64, 3, 3, 3)"
    assert convert_lpips_weights.DEFAULT_OUT == REPO / "relightable3dgaussians_w_torch" / \
        "models" / "_lpips_vgg16.npz"
    monkeypatch.setitem(sys.modules, "torchvision", None)   # as on a machine without it
    monkeypatch.setitem(sys.modules, "torchvision.models", None)
    out = tmp_path / "w.npz"
    with pytest.raises(ImportError, match="torchvision"):
        convert_lpips_weights.main([f"--out={out}"])
    assert os.listdir(tmp_path) == []
