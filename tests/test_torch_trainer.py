"""The torch port's trainer slice against the JAX package, on the CPU.

Density control (`densify_and_prune` fed JAX's own split noise, for both
screen-size variants and a pool too small for the selection), pool growth, the
sky seeding (fed JAX's hemisphere draws), the entry-demand probe and the
budget / row-interval decision, the view order, overflow healing, a 26-step
run of the port's trainer on tests/test_trainer_e2e.py's dataset, the MLP
weights' flax bytes, and checkpoints both ways between the two trainers. The JAX trainer
is built once per module (no training steps). Float results are held to 1e-5
(float32, sums in another order); integer and boolean results, and
everything copied rather than computed, must be equal.
"""

import dataclasses
import json
import os
import shutil
import socket
import struct
import time
import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from relightable3dgaussians_w_tpu import config as jconfig
from relightable3dgaussians_w_tpu import train_step as JTS
from relightable3dgaussians_w_tpu import renderer as jrenderer
from relightable3dgaussians_w_tpu import trainer as jtrainer
from relightable3dgaussians_w_tpu.data.cameras import Camera as JCamera
from relightable3dgaussians_w_tpu.models import gaussians as jG
from relightable3dgaussians_w_tpu.models.nets import init_mlp as jinit_mlp
from relightable3dgaussians_w_tpu.renderer import render as jrender

from relightable3dgaussians_w_torch import checkpoint as CK
from relightable3dgaussians_w_torch import config, convert, train_step as TS, trainer, viewer
from relightable3dgaussians_w_torch.cli import train as cli_train
from relightable3dgaussians_w_torch.models import gaussians as G

from test_torch_ops import assert_image_close, to_t
from test_trainer_e2e import make_dataset

TOL = dict(rtol=1e-5, atol=1e-5)
JRENDER_STATIC = ("envlight_sh_degree", "sky_sh_degree", "specular", "fix_sky", "debug")


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _cfg(data, out, cls=config.Config, **runtime):
    """tests/test_trainer_e2e.py's settings, in either package's Config."""
    cfg = cls()
    cfg.dataset.source_path, cfg.dataset.model_path = data, out
    cfg.optimizer.densify_from_iter = 10
    cfg.optimizer.densification_interval = 15
    cfg.optimizer.opacity_reset_interval = 10_000
    cfg.optimizer.reg_normal_from_iter = 0
    cfg.runtime.pool_capacity = 4096
    for k, v in runtime.items():
        setattr(cfg.runtime, k, v)
    return cfg


def _port_state(jstate):
    g = jax.device_get
    return convert.train_state_from_jax(g(jstate.params), g(jstate.gauss_state),
                                        g(jstate.opt_state.mu), g(jstate.opt_state.nu),
                                        g(jstate.opt_state.count), g(jstate.step))


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """The e2e dataset, a JAX trainer on it (demand-sized budget, no steps) and
    a port trainer on the CPU with the same settings."""
    root = tmp_path_factory.mktemp("trainer")
    data = str(root / "scene")
    make_dataset(data)
    with pytest.MonkeyPatch.context() as mp:   # flax's init op by op takes ~4 s
        mp.setattr(jtrainer, "init_mlp", lambda key, mlp: jax.jit(
            lambda k: jinit_mlp(k, mlp))(key))
        jtr = jtrainer.Relightable3DGWTrainer(_cfg(data, str(root / "jax"), jconfig.Config,
                                                   max_dup=0))
    ttr = trainer.Relightable3DGWTrainer(_cfg(data, str(root / "port"), max_dup=0),
                                         device="cpu")
    return dict(root=root, data=data, jtr=jtr, ttr=ttr)


# ------------------------------------------------------------------ config


def test_config_matches_jax_and_rejects_unported(scene, tmp_path):
    assert config.config_to_dict(config.Config()) == jconfig.config_to_dict(jconfig.Config())
    over = ["runtime.max_dup=0", "optimizer.iterations=7", "runtime.row_intervals=true"]
    yaml_path = tmp_path / "run.yaml"
    yaml_path.write_text("optimizer:\n  densify_grad_threshold: 0.0002\n"
                         "runtime:\n  pool_headroom: 2.0\n")
    assert (config.config_to_dict(config.load_config(over, str(yaml_path)))
            == jconfig.config_to_dict(jconfig.load_config(over, str(yaml_path))))
    for over, queue in ((["runtime.data_parallel=2"], "queue 1 item 5"),
                        (["runtime.gauss_shards=2"], "queue 1 item 5"),
                        (["runtime.coordinator_address=h:1"], "queue 1 item 5")):
        with pytest.raises(ValueError, match=queue):
            cli_train.main([f"dataset.source_path={scene['data']}",
                            f"dataset.model_path={scene['root'] / 'x'}", *over, "--device=cpu"])
    if not torch.cuda.is_available():   # the CLI trains on the card by default
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli_train.main([f"dataset.source_path={scene['data']}",
                            f"dataset.model_path={scene['root'] / 'x'}"])


def test_eval_halffit_matches_jax(tmp_path, scene, monkeypatch):
    """With test cameras (dataset.eval=true) the port's evaluation report runs
    the half-fit: the mean embedding fitted on the left half of up to
    runtime.eval_halffit_views test views, the right-half masked PSNR logged as
    test_psnr_halffit. From the JAX trainer's state and the same test view, it
    equals the JAX trainer's within 1e-3 dB (3 fit steps here)."""
    data = str(tmp_path / "scene")
    shutil.copytree(scene["data"], data)
    with open(os.path.join(data, "transforms_train.json")) as f:
        meta = json.load(f)
    with open(os.path.join(data, "transforms_test.json"), "w") as f:
        json.dump(dict(meta, frames=meta["frames"][:1]), f)
    cfg = _cfg(data, str(tmp_path / "out"))
    cfg.dataset.eval = True
    cfg.optimizer.optim_embeddings_test_iters = 3
    tr = trainer.Relightable3DGWTrainer(cfg, device="cpu")
    assert len(tr.test_cameras) == 1 and cfg.runtime.eval_halffit_views == 2
    jtr = scene["jtr"]
    tr.state = _port_state(jtr.state)
    tr.rcfg = tr.rcfg._replace(max_dup=jtr.rcfg.max_dup, row_intervals=jtr.rcfg.row_intervals)
    tr.evaluate_report(7)

    cam = tr.test_cameras[0]
    fields = {f.name: getattr(cam, f.name) for f in dataclasses.fields(cam) if f.init}
    monkeypatch.setattr(jtr, "test_cameras", [JCamera(**fields)])
    monkeypatch.setattr(jtr.cfg.optimizer, "optim_embeddings_test_iters", 3)
    # JAX's report renders eagerly op by op; one jitted render compiles once.
    monkeypatch.setattr(jrenderer, "render", jax.jit(jrenderer.render, static_argnums=(5,),
                                                     static_argnames=JRENDER_STATIC))
    jtr.evaluate_report(7, n_train_views=0)   # the half-fit alone is compared

    def halffit(path):
        recs = [json.loads(line) for line in open(path)]
        return [r["test_psnr_halffit"] for r in recs if "test_psnr_halffit" in r]

    got, want = halffit(tr.log_path), halffit(jtr.log_path)
    assert len(got) == 1 and np.isfinite(got[0])
    assert abs(got[0] - want[-1]) < 1e-3, (got, want)


# ------------------------------------------------------------------ density control


def _pool(cap, seed=0, n=120, n_sky=30):
    """A JAX pool with mixed scales, low-opacity rows, sky rows, random
    densification stats and random Adam moments."""
    rng = np.random.RandomState(seed)
    pts = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    params, state = jG.init_from_points(pts, np.full(n, 0.01, np.float32), cap)
    th, ph = rng.uniform(0.2, 1.2, n_sky), rng.uniform(-1.2, 1.2, n_sky)
    sky = np.stack([8 * np.sin(th) * np.sin(ph), -8 * np.cos(th), 8 * np.sin(th) * np.cos(ph)],
                   -1).astype(np.float32)
    params, state = jG.augment_with_sky(params, state, sky, np.full(n_sky, 0.05), 8.0,
                                        np.array([0.1, -0.2, 0.3], np.float32))
    m = n + n_sky
    rnd = lambda *s: np.asarray(rng.randn(*s), np.float32)
    scal = np.zeros((cap, 3), np.float32)
    scal[:m] = np.log(rng.uniform(0.01, 0.2, (m, 3)))
    rot = np.zeros((cap, 4), np.float32)
    rot[:m] = rnd(m, 4)
    op = np.zeros((cap, 1), np.float32)
    op[:m] = rng.uniform(-7, 2, (m, 1))
    params = params._replace(scaling=jnp.asarray(scal), rotation=jnp.asarray(rot),
                             opacity=jnp.asarray(op))
    alive = np.asarray(state.alive)
    state = state._replace(
        xyz_grad_accum=jnp.asarray(np.where(alive, rng.uniform(0, 4e-4, cap), 0), jnp.float32),
        denom=jnp.asarray(np.where(alive, rng.randint(0, 4, cap), 0), jnp.float32),
        max_radii2d=jnp.asarray(np.where(alive, rng.uniform(0, 30, cap), 0), jnp.float32))
    moments = tuple(jG.GaussianParams(*[jnp.asarray(rnd(*np.shape(a))) for a in params])
                    for _ in range(2))
    return params, state, moments


@pytest.mark.parametrize("max_screen_size,cap", [(None, 600), (20, 600), (None, 200)])
def test_densify_and_prune_matches_jax(max_screen_size, cap):
    jp, js, jm = _pool(cap)
    key = jax.random.PRNGKey(3)
    noise = jax.random.normal(key, (2, cap, 3))   # the draw inside the JAX function
    args = (1e-4, 0.005, 5.0, max_screen_size)
    jp2, js2, jm2, jrep = jax.jit(jG.densify_and_prune, static_argnums=(7,))(
        key, jp, js, jm, *args)
    tp, ts = convert.gaussians_from_numpy({k: np.asarray(v) for k, v in jp._asdict().items()},
                                          {k: np.asarray(v) for k, v in js._asdict().items()})
    tm = tuple(G.GaussianParams(*[to_t(a) for a in m]) for m in jm)
    tp2, ts2, tm2, trep = G.densify_and_prune(tp, ts, tm, *args, percent_dense=0.01,
                                              noise=to_t(noise))
    for name in trep._fields:
        assert int(getattr(trep, name)) == int(getattr(jrep, name)), name
    assert int(trep.n_cloned) > 0 and int(trep.n_split) > 0
    if cap == 200:
        assert int(trep.overflow) > 0
    if max_screen_size is not None:
        assert int(trep.n_pruned) > 0
    for name in G.GaussianParams._fields:
        np.testing.assert_allclose(_np(getattr(tp2, name)), np.asarray(getattr(jp2, name)),
                                   err_msg=name, **TOL)
    for name in G.GaussianState._fields:
        np.testing.assert_array_equal(_np(getattr(ts2, name)), np.asarray(getattr(js2, name)),
                                      err_msg=name)
    for t_m, j_m in zip(tm2, jm2):
        for name in G.GaussianParams._fields:
            np.testing.assert_array_equal(_np(getattr(t_m, name)), np.asarray(getattr(j_m, name)),
                                          err_msg=name)


def test_grow_train_state_matches_jax(scene):
    jstate = scene["jtr"].state
    cap = jstate.gauss_state.alive.shape[0]
    j_grown = JTS.grow_train_state(jstate, cap + 1000)
    t_grown = TS.grow_train_state(_port_state(jstate), cap + 1000)
    assert t_grown.gauss_state.alive.shape[0] == cap + 1000
    for got, want in zip(CK.state_leaves(t_grown), jax.tree_util.tree_leaves(j_grown)):
        np.testing.assert_array_equal(got, np.asarray(want))


# ------------------------------------------------------------------ trainer set-up


def test_sky_seeding_matches_jax(scene):
    jtr = scene["jtr"]
    pts = jtr.scene_info.point_cloud.points.astype(np.float32)
    key = jax.random.PRNGKey(5)
    j_pts, j_dist, j_center = jtrainer.seed_sky_points(key, pts, jtr.train_cameras)
    num = int(5000 * j_dist)
    ky, kphi = jax.random.split(key)
    draws = (np.asarray(jax.random.uniform(ky, (num,))), np.asarray(jax.random.uniform(kphi, (num,))))
    t_pts, t_dist, t_center = trainer.seed_sky_points(pts, scene["ttr"].train_cameras,
                                                      draws=draws)
    assert t_dist == j_dist and len(t_pts) == len(j_pts) > 0
    np.testing.assert_allclose(t_center, j_center)
    np.testing.assert_allclose(t_pts, j_pts, **TOL)


def test_probe_and_budget_match_jax(scene):
    """On the JAX trainer's own pool, the port's probe measures the same rect
    and interval demands, and the sizing rule picks the same budget and
    row-interval setting as the JAX trainer did."""
    jtr, ttr = scene["jtr"], scene["ttr"]
    j_rect, j_iv = jtr._probe_entry_demand()
    ttr.state = _port_state(jtr.state)
    t_rect, t_iv = ttr._probe_entry_demand()
    assert (t_rect, t_iv) == (j_rect, j_iv) and t_iv < t_rect
    row_iv, max_dup = trainer.size_entry_budget(0, False, True, t_rect, t_iv)
    assert (row_iv, max_dup) == (jtr.rcfg.row_intervals, jtr.rcfg.max_dup)
    # The cut is under 15% on this isotropic scene: the auto decision keeps
    # intervals off, and runtime.row_intervals switches them on.
    assert not row_iv
    sized = min(max(((int(t_iv * 1.3) + 4095) // 4096) * 4096, 1 << 15), 1 << 23)
    assert trainer.size_entry_budget(0, True, True, t_rect, t_iv) == (True, sized)
    assert trainer.size_entry_budget(1 << 14, True, True, t_rect, t_iv) == (True, 1 << 14)
    # The port's own trainer (its own sky draws and initial nets) decided alike.
    assert ttr.rcfg.row_intervals == row_iv and ttr.rcfg.max_dup % 4096 == 0


def test_view_sampling_matches_jax(scene, monkeypatch):
    """The first 20 sampled views (the train loop with its step stubbed out)."""
    jtr, ttr = scene["jtr"], scene["ttr"]
    j_uids, t_uids = [], []

    def j_step(state, cam, img, sky, occ, uid, key, bg):
        j_uids.append(int(uid))
        return state, types.SimpleNamespace(loss=0.0, l1=0.0, psnr=0.0, num_alive=0,
                                            overflow=0)

    def t_step(state, cam, img, sky, occ, uid, draws, bg, mlp, cfg, rcfg, device):
        t_uids.append(int(uid))
        z = torch.zeros(())
        return state, TS.StepAux(z, z, z, None, None, torch.zeros((), dtype=torch.int64), z)

    for tr in (jtr, ttr):
        monkeypatch.setattr(tr, "evaluate_report", lambda it: None)
        monkeypatch.setattr(tr, "save", lambda it: None)
    monkeypatch.setattr(jtr, "fns", jtr.fns._replace(train_step=j_step))
    monkeypatch.setattr(trainer.TS, "train_step", t_step)
    jtr.train(iterations=20, save_iterations=(), log_every=1000, test_iterations=())
    ttr.train(iterations=20, save_iterations=(), log_every=1000, test_iterations=())
    assert t_uids == j_uids and len(set(t_uids)) == len(ttr.train_views)


def _recv(sock, n):
    out = b""
    while len(out) < n:
        chunk = sock.recv(n - len(out))
        assert chunk, "server closed"
        out += chunk
    return out


def test_viewer_hook_serves_the_training_state(scene):
    """The train loop's viewer hook: a json request for training view 0 gets
    the trainer's own render of that view (to a uint8 step)."""
    ttr = scene["ttr"]
    cam = ttr.train_cameras[0]
    server = viewer.ViewerServer(port=0, protocol="json", device="cpu")
    try:
        with socket.create_connection(("127.0.0.1", server.port), timeout=60) as sock:
            req = json.dumps({"viewmat": cam.world_view.tolist(), "fovx": cam.fovx,
                              "fovy": cam.fovy, "width": ttr.W, "height": ttr.H,
                              "embedding_index": 0}).encode()
            sock.sendall(struct.pack("<I", len(req)) + req)
            deadline = time.time() + 60
            while not viewer.handle_viewer_request(server, trainer._ViewerHost(ttr)):
                assert time.time() < deadline, "no frame served"
                time.sleep(0.01)
            (n,) = struct.unpack("<I", _recv(sock, 4))
            got = np.frombuffer(_recv(sock, n), np.uint8).astype(int)
    finally:
        server.close()
    with torch.no_grad():
        img = ttr._render_view(ttr.train_views[0], ttr.state.params["embeddings"][0][None]).render
    want = (torch.clamp(img, 0, 1) * 255).to(torch.uint8).numpy().ravel().astype(int)
    diff = np.abs(got - want)
    assert n == ttr.W * ttr.H * 3 and want.max() > want.min()
    assert diff.max() <= 1 and (diff > 0).mean() < 1e-3


# ------------------------------------------------------------------ training runs


def test_binning_overflow_rejects_one_update_and_heals(tmp_path, scene):
    """tests/test_overflow_recovery.py's pattern: an entry budget far too small
    makes the first step overflow and keep its parameters; the loop grows the
    budget before the next step, whose update lands."""
    cfg = _cfg(scene["data"], str(tmp_path / "out"), max_dup=256)
    cfg.optimizer.densify_from_iter = 10_000
    tr = trainer.Relightable3DGWTrainer(cfg, device="cpu")
    xyz0 = tr.state.params["gaussians"].xyz.clone()
    tr.train(iterations=2, save_iterations=(), log_every=1, test_iterations=())
    recs = [json.loads(line) for line in open(tr.log_path)]
    steps = [r for r in recs if "loss" in r]
    heals = [r for r in recs if r.get("event") == "heal_binning_overflow"]
    assert steps[0]["overflow"] > 0 and steps[1]["overflow"] == 0
    assert len(heals) == 1 and heals[0]["iter"] == 1 and tr.rcfg.max_dup == heals[0]["max_dup"]
    assert tr.rcfg.max_dup >= 256 + steps[0]["overflow"]
    assert int(tr.state.step) == 2
    assert float((tr.state.params["gaussians"].xyz - xyz0).abs().max()) > 0


@pytest.fixture(scope="module")
def port_run(scene):
    """26 steps of the port's trainer on the CPU, configured as the CLI does,
    with one densify round (iteration 25), the opacity reset (iteration 10), a
    profiled window (steps 2-3) and the loss logged every 10 steps."""
    out = str(scene["root"] / "port_run")
    cfg = config.load_config([f"dataset.source_path={scene['data']}", f"dataset.model_path={out}",
                              "optimizer.densify_from_iter=10",
                              "optimizer.densification_interval=25",
                              "optimizer.opacity_reset_interval=10000",
                              "optimizer.reg_normal_from_iter=0", "runtime.pool_capacity=4096",
                              "runtime.max_dup=16384", "optimizer.iterations=26",
                              "runtime.profile_steps=2:4"])
    tr = trainer.Relightable3DGWTrainer(cfg, device="cpu")
    tr.train(log_every=10)
    return dict(tr=tr, out=out, recs=[json.loads(line) for line in open(tr.log_path)])


def test_port_trainer_end_to_end(port_run):
    tr, out, recs = port_run["tr"], port_run["out"], port_run["recs"]
    losses = [r["loss"] for r in recs if "loss" in r]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    events = {r["event"]: r for r in recs if "event" in r}
    assert events["densify"]["n_cloned"] + events["densify"]["n_split"] > 0
    assert {"opacity_reset", "evaluate", "save"} <= set(events)
    assert any("train_psnr" in r for r in recs)
    assert os.path.getsize(os.path.join(out, "profile", "steps_2_4.json")) > 0
    assert os.path.isdir(os.path.join(out, "panels", "iteration_26"))
    for rel in ("point_cloud/iteration_26/point_cloud.ply",
                "checkpoint_embeddings/iteration_26/embeddings_weights.npz",
                "checkpoint_MLP/iteration_26/MLP_weights.npz",
                "full_state/iteration_26/state.npz", "cfg_args", "relightable3DG-W_run.yaml"):
        assert os.path.exists(os.path.join(out, rel)), rel
    assert len(os.listdir(os.path.join(out, "envlights_sh/iteration_26"))) == 3
    with open(os.path.join(out, "cameras.json")) as f:
        cams = json.load(f)
    assert len(cams) == 3 and {"id", "img_name", "width", "height", "position", "rotation",
                               "fy", "fx"} <= set(cams[0])

    # Full-state round trip, then the PLY warm start (compacted pool).
    st = tr.state
    tr.load_full_state(26)
    for got, want in zip(CK.state_leaves(tr.state), CK.state_leaves(st)):
        np.testing.assert_array_equal(got, want)
    shutil.copytree(os.path.join(out, "full_state"), os.path.join(out, "full_state.bak"))
    shutil.rmtree(os.path.join(out, "full_state"))
    try:
        tr.load_checkpoint(-1)
    finally:
        os.rename(os.path.join(out, "full_state.bak"), os.path.join(out, "full_state"))
    alive = st.gauss_state.alive
    assert int(tr.state.gauss_state.alive.sum()) == int(alive.sum()) and int(tr.state.step) == 26
    xyz_l = G.get_xyz(tr.state.params["gaussians"], tr.state.gauss_state)[tr.state.gauss_state.alive]
    xyz_s = G.get_xyz(st.params["gaussians"], st.gauss_state)[alive]
    np.testing.assert_allclose(np.sort(_np(xyz_l).ravel()), np.sort(_np(xyz_s).ravel()),
                               atol=1e-5)
    tr.state = st


# ------------------------------------------------------------------ checkpoint interop


def test_jax_checkpoint_loads_into_port(scene):
    """The JAX trainer saves (no steps); the port loads the full state leaf for
    leaf, and from the PLY path renders a view within the image tolerance of
    the JAX render of the same state."""
    jtr, ttr = scene["jtr"], scene["ttr"]
    jtr.save(7)
    ttr.model_path = jtr.model_path
    try:
        ttr.load_checkpoint(7)                       # takes the full-state bundle
        for got, want in zip(CK.state_leaves(ttr.state), jax.tree_util.tree_leaves(jtr.state)):
            np.testing.assert_array_equal(got, np.asarray(want))
        shutil.rmtree(os.path.join(jtr.model_path, "full_state"))
        ttr.load_checkpoint(7)                       # PLY + embeddings + MLP bytes
    finally:
        ttr.model_path = scene["ttr"].cfg.dataset.model_path
    assert int(ttr.state.step) == 7
    view = ttr.train_views[0]
    with torch.no_grad():
        t_img = ttr._render_view(view, ttr.state.params["embeddings"][0][None]).render

    jp = jtr.state.params
    envl, sky = jtr.mlp.apply({"params": jp["mlp"]}, jp["embeddings"][0][None],
                              deterministic=True)
    jv = jtr.train_views[0]
    m = jtr.cfg.model
    j_img = jax.jit(jrender, static_argnums=(5, 8, 9, 10, 11, 12))(
        jp["gaussians"], jtr.state.gauss_state, envl[0], sky, jv["cam"].matrices(), jtr.rcfg,
        jtr.bg_color, jnp.asarray(jv["sky_mask"]), m.envlight_sh_degree, m.sky_sh_degree,
        m.specular, m.fix_sky, False).render
    assert float(np.abs(np.asarray(j_img)).max()) > 0
    assert_image_close(_np(t_img), np.asarray(j_img))


def test_mlp_bytes_match_flax(scene):
    """The port writes the MLP weights byte for byte as the JAX trainer's
    flax.serialization.to_bytes does, and reads those bytes back exactly."""
    from flax import serialization

    want = serialization.to_bytes(jax.device_get(scene["jtr"].state.params["mlp"]))
    tree = _port_state(scene["jtr"].state).params["mlp"]
    assert CK.mlp_to_bytes(tree) == want
    back = CK.mlp_from_bytes(want)
    assert back.keys() == tree.keys()
    for k in tree:
        assert torch.equal(back[k], tree[k]), k


def test_port_checkpoint_loads_into_jax(scene, port_run):
    """The port saves (after 26 steps); the JAX trainer's load_full_state reads
    every leaf, and its load_checkpoint PLY path the same Gaussians, embeddings
    and MLP weights."""
    jtr, tr = scene["jtr"], port_run["tr"]
    want = CK.state_leaves(tr.state)
    saved_path, saved_state = jtr.model_path, jtr.state
    jtr.model_path = port_run["out"]
    try:
        jtr.load_full_state(26)
        for got, w in zip(jax.tree_util.tree_leaves(jtr.state), want):
            np.testing.assert_array_equal(np.asarray(got), w)
        # The PLY path loads into a pool of the current capacity (the port's now).
        shutil.copytree(os.path.join(port_run["out"], "full_state"),
                        os.path.join(port_run["out"], "full_state.bak"))
        shutil.rmtree(os.path.join(port_run["out"], "full_state"))
        try:
            jtr.load_checkpoint(26)
        finally:
            os.rename(os.path.join(port_run["out"], "full_state.bak"),
                      os.path.join(port_run["out"], "full_state"))
        js, ts = jtr.state, tr.state
        n = int(ts.gauss_state.alive.sum())
        assert int(jnp.sum(js.gauss_state.alive)) == n
        np.testing.assert_array_equal(np.asarray(js.params["embeddings"]),
                                      _np(ts.params["embeddings"]))
        t_mlp = convert.mlp_params_to_flax(ts.params["mlp"])
        for layer in t_mlp:
            for leaf in ("kernel", "bias"):
                np.testing.assert_array_equal(np.asarray(js.params["mlp"][layer][leaf]),
                                              t_mlp[layer][leaf])
        alive = _np(ts.gauss_state.alive)
        for name in ("opacity", "scaling", "rotation"):
            np.testing.assert_array_equal(np.asarray(getattr(js.params["gaussians"], name))[:n],
                                          _np(getattr(ts.params["gaussians"], name))[alive])
    finally:
        jtr.model_path, jtr.state = saved_path, saved_state
