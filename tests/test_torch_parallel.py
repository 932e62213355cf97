"""The port's multi-device modules (`parallel/`) against the JAX package, on the CPU.

Tile-parallel rendering runs in this process over a list of CPU devices. The
modules that need ranks run in gloo groups of worker processes
(`_torch_parallel_worker.py`, torch and the port only, rendezvous through a
file): one group of 2 ranks (the gauss-sharded render, the data = 2 step) and
one of 4 (data 2 x gauss 2: the fused step, the collective pull, densify on
the sharded pool), each spawned once per module; every check below reads their
results. The train CLI runs as 4 ranks over tcp. JAX's references run on the
8 virtual CPU devices of tests/conftest.py, jitted once each.

Tolerances: images bitwise against the port's single-device render and
within the JAX package's image tolerance of JAX's; gradients within max |delta|
/ max |ref| < 5e-3 of JAX's (the kernels' tolerance) and < 1e-5 between the
port's own decompositions; losses within 1e-5 relative; Adam microsteps fed
the same gradients within 1e-6.
"""

import json
import os
import socket
import subprocess
import sys
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from relightable3dgaussians_w_tpu.models.nets import MLPNet as JMLPNet, init_mlp as jinit_mlp
from relightable3dgaussians_w_tpu.ops.rasterize import RasterizerConfig as JRasterizerConfig
from relightable3dgaussians_w_tpu.parallel import data_parallel as jdp
from relightable3dgaussians_w_tpu.parallel.gauss_shard import render_gauss_sharded as j_gs
from relightable3dgaussians_w_tpu.parallel.mesh import make_mesh as jmake_mesh
from relightable3dgaussians_w_tpu.parallel.tile_parallel import render_tile_sharded as j_tile

from relightable3dgaussians_w_torch import checkpoint as CK, convert, renderer
from relightable3dgaussians_w_torch import train_step as TS
from relightable3dgaussians_w_torch.config import Config
from relightable3dgaussians_w_torch.models import gaussians as G
from relightable3dgaussians_w_torch.ops import rasterize
from relightable3dgaussians_w_torch.parallel import data_parallel as DP
from relightable3dgaussians_w_torch.parallel import tile_parallel as TP

from test_rasterize import make_scene
from test_torch_ops import assert_image_close, to_t, torch_cam, torch_rcfg
import test_train_step
from test_train_step import build_setup
from test_trainer_e2e import make_dataset
import _torch_threads

_torch_threads.share_cores()

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_torch_parallel_worker.py")
JOIN_S = 120
GRAD_TOL = 5e-3


def rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


class Ranks:
    """`world` worker processes started now and joined later: the join waits
    JOIN_S at most and kills every rank when one fails or the wait runs out."""

    def __init__(self, args_of_rank, world):
        env = dict(os.environ, OMP_NUM_THREADS="1")
        env.pop("JAX_PLATFORMS", None)
        self.procs = [subprocess.Popen([sys.executable, WORKER, *args_of_rank(r)], env=env,
                                       stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True) for r in range(world)]
        self.outs = None

    def join(self):
        if self.outs is None:
            try:
                self.outs = [p.communicate(timeout=JOIN_S)[0] for p in self.procs]
            finally:
                self.kill()
        for r, (p, o) in enumerate(zip(self.procs, self.outs)):
            assert p.returncode == 0, f"rank {r} failed:\n{o[-4000:]}"
        return self.outs

    def kill(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.communicate()


class Group(Ranks):
    """A gloo group of the worker (file rendezvous in `tmp`), fed `inputs`."""

    def __init__(self, name, world, tmp, inputs: dict):
        inp = str(tmp / f"{name}_in.npz")
        np.savez(inp, **inputs)
        rdv = str(tmp / f"{name}_rendezvous")
        self.name, self.world, self.tmp = name, world, tmp
        super().__init__(lambda r: [name, str(r), str(world), rdv, inp, str(tmp)], world)

    def results(self):
        self.join()
        return [dict(np.load(self.tmp / f"{self.name}_rank{r}.npz")) for r in range(self.world)]


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# ------------------------------------------------------------------ tile-parallel


@pytest.fixture(scope="module")
def tile_scene():
    arrs, cam, cfg, host = make_scene(n=300, seed=5, W=64, H=128)
    cfg = cfg._replace(max_dup=1 << 15)
    names = ("means3d", "scales", "quats", "opacities", "colors", "bg")
    t_args = [to_t(arrs[k]) for k in names]
    t_cam, t_cfg = torch_cam(cam), torch_rcfg(cfg)._replace(max_dup=1 << 15)
    ref = rasterize.rasterize(*t_args, t_cam, t_cfg, device="cpu")
    return dict(arrs=arrs, cam=cam, cfg=cfg, t_args=t_args, t_cam=t_cam, t_cfg=t_cfg, ref=ref)


@pytest.mark.parametrize("k", [2, 4])
def test_tile_parallel_bitwise_to_rasterize(tile_scene, k):
    s = tile_scene
    ref, ref_aux = s["ref"]
    img, aux = TP.rasterize_tile_sharded(*s["t_args"], s["t_cam"], s["t_cfg"], ["cpu"] * k)
    assert torch.equal(img, ref) and torch.equal(aux.alpha, ref_aux.alpha)
    assert torch.equal(aux.radii, ref_aux.radii) and torch.equal(aux.depth, ref_aux.depth)
    assert int(aux.overflow) == 0


@pytest.mark.parametrize("k", [2, 4])
def test_tile_parallel_matches_jax(tile_scene, k):
    s = tile_scene
    names = ("means3d", "scales", "quats", "opacities", "colors", "bg")
    mesh = jmake_mesh(data=k)
    j_img, j_alpha = jax.jit(partial(j_tile, cam=s["cam"], cfg=s["cfg"], mesh=mesh))(
        *[s["arrs"][n] for n in names])
    img, alpha = TP.render_tile_sharded(*s["t_args"], s["t_cam"], s["t_cfg"], ["cpu"] * k)
    assert_image_close(img.numpy(), j_img)
    assert_image_close(alpha.numpy(), j_alpha)


def test_tile_parallel_raster_fn_through_renderer(tile_scene):
    """The raster function through render_from_inputs (the render CLI's use):
    every AOV and the aux equal to the single-device render's."""
    s = tile_scene
    xyz, scales, quats, op, _, _ = s["t_args"]
    n = xyz.shape[0]
    colors = to_t(np.random.RandomState(1).uniform(0, 1, (n, 21)).astype(np.float32))
    inp = renderer.RenderInputs(xyz, scales, quats, op[:, None], colors)
    state = G.GaussianState(torch.ones(n, dtype=torch.bool), torch.zeros(n, dtype=torch.bool),
                            torch.zeros(3), torch.zeros(n), torch.zeros(n), torch.zeros(n))
    args = (inp, state, s["t_cam"], s["t_cfg"], torch.tensor([0.2, 0.3, 0.4]),
            torch.ones(128, 64))
    ref = renderer.render_from_inputs(*args, device="cpu")
    got = renderer.render_from_inputs(*args, device="cpu",
                                      raster_fn=TP.make_tile_parallel_raster_fn(["cpu"] * 4))
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


def test_tile_parallel_rejects_indivisible_grid():
    arrs, cam, cfg, _ = make_scene(n=50, seed=1, W=64, H=80)   # grid_y = 5
    args = [to_t(arrs[k]) for k in ("means3d", "scales", "quats", "opacities", "colors", "bg")]
    with pytest.raises(ValueError, match="grid_y=5"):
        TP.render_tile_sharded(*args, torch_cam(cam), torch_rcfg(cfg), ["cpu"] * 2)


def test_tile_parallel_grads_match_single_device(tile_scene):
    s = tile_scene
    rng = np.random.RandomState(0)
    w_img = to_t(rng.randn(128, 64, 3).astype(np.float32))
    w_alpha = to_t(rng.randn(128, 64).astype(np.float32))

    def grads(fn):
        args = [a.clone().requires_grad_(True) for a in s["t_args"][:5]]
        probe = torch.zeros((args[0].shape[0], 2), requires_grad=True)
        img, aux = fn(*args, s["t_args"][5], s["t_cam"], s["t_cfg"], mean2d_probe=probe)
        ((img * w_img).sum() + (aux.alpha * w_alpha).sum()).backward()
        return [a.grad for a in args] + [probe.grad]

    ref = grads(partial(rasterize.rasterize, device="cpu"))
    got = grads(TP.make_tile_parallel_raster_fn(["cpu"] * 4))
    for g, r in zip(got, ref):
        assert float(r.abs().max()) > 0
        assert rel_err(g, r) < 1e-5


# ------------------------------------------------------------------ rank groups


@partial(jax.jit, static_argnums=0)
def _jax_step_draws(jmlp, key, mlp_params, e):
    k_noise, k_drop, k_envl = jax.random.split(key, 3)
    _, inter = jmlp.apply({"params": mlp_params}, e[None], deterministic=False,
                          rngs={"dropout": k_drop}, capture_intermediates=True,
                          mutable=["intermediates"])
    keep = inter["intermediates"]["Dropout_0"]["__call__"][0] != 0
    return (jax.random.normal(k_noise, (25, 3)) * 0.025, keep,
            jax.random.uniform(k_envl, (10, 3), minval=-1.0, maxval=1.0))


def _jax_draws(key, tstate, jmlp, uid):
    """A JAX step's draws from its key, as its make_leaf_inputs takes them
    (compiled once: the eager flax apply compiles op by op)."""
    return tuple(np.asarray(a) for a in _jax_step_draws(
        jmlp, key, tstate.params["mlp"], tstate.params["embeddings"][uid]))


def _port_tree(tree, gauss_state, ref):
    """A JAX parameter-shaped tree (numpy) in the port's layout, its dicts in
    the key order of `ref` (the state the ranks load)."""
    def order(t, r):
        return {k: order(t[k], r[k]) for k in r} if isinstance(r, dict) else t
    return order(convert.train_state_from_jax(tree, gauss_state, tree, tree, 0, 0).params, ref)


@pytest.fixture(scope="module")
def dp_setup():
    """tests/test_train_step.py's scene at step 1 with a batch of 2 images, the
    port's copy of the state and JAX's per-image draws: the ranks' inputs."""
    with pytest.MonkeyPatch.context() as mp:   # flax's init op by op takes ~4 s
        mp.setattr(test_train_step, "init_mlp", lambda key, mlp: jax.jit(
            lambda k: jinit_mlp(k, mlp))(key))
        tstate, _, cam, _, _, _, jcfg = build_setup()
    tstate = tstate._replace(step=jnp.asarray(1))
    jmlp = JMLPNet(sh_degree_envl=4, sh_degree_sky=1)
    gt = np.random.RandomState(0).uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    uid = np.array([0, 1])
    batch = jdp.CameraBatch(
        viewmat=jnp.stack([cam.viewmat] * 2), projmat=jnp.stack([cam.projmat] * 2),
        campos=jnp.stack([cam.campos] * 2), tan_fovx=jnp.stack([cam.tan_fovx] * 2),
        tan_fovy=jnp.stack([cam.tan_fovy] * 2), gt_image=jnp.asarray(gt),
        sky_mask=jnp.ones((2, 64, 64)), occluders_mask=jnp.ones((2, 64, 64)),
        uid=jnp.asarray(uid))
    keys = jax.random.split(jax.random.PRNGKey(3), 2)
    g = jax.device_get
    gstate = g(tstate.gauss_state)
    state = convert.train_state_from_jax(g(tstate.params), gstate, g(tstate.opt_state.mu),
                                         g(tstate.opt_state.nu), g(tstate.opt_state.count),
                                         g(tstate.step))
    state = CK.state_from_leaves(CK.state_leaves(state))   # as the ranks load it
    draws = [_jax_draws(keys[i], tstate, jmlp, int(uid[i])) for i in range(2)]
    inputs = dict(viewmat=np.asarray(cam.viewmat), projmat=np.asarray(cam.projmat),
                  campos=np.asarray(cam.campos), tanf=np.asarray(cam.tan_fovx), gt=gt, uid=uid,
                  noise=np.stack([d[0] for d in draws]), keep=np.stack([d[1] for d in draws]),
                  dirs=np.stack([d[2] for d in draws]),
                  **{f"leaf_{i}": a for i, a in enumerate(CK.state_leaves(state))})
    return dict(tstate=tstate, jcfg=jcfg, jmlp=jmlp, batch=batch, keys=keys, gstate=gstate,
                state=state, inputs=inputs)


@pytest.fixture(scope="module", autouse=True)
def ranks(tmp_path_factory, dp_setup, scene320):
    """Every rank group of the module, started before its first test so that
    they run while the JAX references compile: the 4-rank train CLI, the
    2-rank group and the 4-rank group."""
    tmp = tmp_path_factory.mktemp("ranks")
    data, out = str(tmp / "scene"), str(tmp / "out")
    make_dataset(data, n_views=4)
    port = free_port()
    started = dict(out=tmp / "out",
                   cli=Ranks(lambda r: ["cli", str(r), "4", str(port), data, out], 4))
    g2_inputs = {**{k: np.asarray(v, np.float32) for k, v in scene320[1].items()
                    if k not in ("W", "H")}, "W": 64, "H": 128, **dp_setup["inputs"]}
    started["g2"] = Group("g2", 2, tmp, g2_inputs)
    started["g4"] = Group("g4", 4, tmp, dp_setup["inputs"])
    yield started
    for group in ("cli", "g2", "g4"):
        started[group].kill()


@pytest.fixture(scope="module")
def dp_ref(dp_setup):
    """JAX's per-image gradients on make_mesh(data=2), and its
    make_dp_train_step on them."""
    tstate, jcfg, jmlp = dp_setup["tstate"], dp_setup["jcfg"], dp_setup["jmlp"]
    batch, keys, gstate, state = (dp_setup[k] for k in ("batch", "keys", "gstate", "state"))
    jrcfg = JRasterizerConfig(width=64, height=64, max_dup=1 << 14, max_tiles_per_gauss=32,
                              lmax_per_tile=256, tile_chunk=4)
    mesh = jmake_mesh(data=2, gauss=1)
    n = tstate.gauss_state.alive.shape[0]
    per_image = jax.jit(jdp.make_per_image_grads(jmlp, jcfg, jrcfg, mesh))
    losses, auxs, (pg, probe) = jax.device_get(per_image(
        tstate.params, tstate.gauss_state, jnp.zeros((n, 2)), batch, keys, tstate.step,
        jnp.zeros(3)))
    # Per-image gradient leaves in the port's order (its tree, then the probe).
    like = _port_tree(jax.tree_util.tree_map(lambda a: a[0], pg), gstate, state.params)
    pg_b = [_port_tree(jax.tree_util.tree_map(lambda a: a[i], pg), gstate, state.params)
            for i in range(2)]
    grads_b = [TS.tree_leaves(t) + [to_t(probe[i])] for i, t in enumerate(pg_b)]
    steps = {}

    def jax_step(overflow):
        """JAX's make_dp_train_step on these per-image gradients (its own
        make_per_image_grads stands in with them), with the images' overflow."""
        if overflow in steps:
            return steps[overflow]
        out = jax.tree_util.tree_map(jnp.asarray, (losses, dict(auxs, overflow=np.array(overflow)),
                                                   (pg, probe)))
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jdp, "make_per_image_grads", lambda *a: lambda *b: out)
            # Compiled at XLA's optimization level 0, which rounds each op as
            # the port's eager ops do (the optimizing compiler contracts
            # Adam's moment updates into FMAs).
            mp.setattr(jax, "jit", partial(jax.jit, compiler_options={
                "xla_backend_optimization_level": 0}))
            step = jdp.make_dp_train_step(jmlp, jcfg, jrcfg, mesh)
        # The step donates its state: give it a copy.
        fresh = jax.tree_util.tree_map(jnp.array, tstate)
        new, metrics = step(jdp.shard_train_state(fresh, mesh), batch, keys, jnp.zeros(3))
        steps[overflow] = jax.device_get(new), jax.device_get(metrics)
        return steps[overflow]

    return dict(state=state, losses=losses, like=like, grads_b=grads_b, jax_step=jax_step)


@pytest.fixture(scope="module")
def scene320():
    _, _, _, host = make_scene(n=320, seed=3, W=64, H=128)
    w = np.random.RandomState(4).randn(128, 64, 3).astype(np.float32)
    return host, dict(means=host["means"], scales=host["scales"], quats=host["quats"],
                      opac=host["opac"], colors=host["colors"], bg=host["bg"],
                      viewmat=host["viewmat"], projmat=host["projmat"], campos=np.zeros(3),
                      tanf=np.float32(host["tanf"]), W=64, H=128, w_img=w)


@pytest.fixture(scope="module")
def group2(ranks):
    """The 2-rank group: the gauss-sharded render and the data = 2 step."""
    return ranks["g2"].results()


@pytest.fixture(scope="module")
def group4(ranks):
    """The 4-rank group: data 2 x gauss 2."""
    return ranks["g4"].results()


# ------------------------------------------------------------------ gauss-sharded


def test_gauss_sharded_bitwise_to_rasterize(group2):
    for r in group2:
        assert bool(r["gs_bitwise"]) and int(r["gs_overflow"]) == 0


def test_gauss_sharded_matches_jax(group2, scene320):
    host, _ = scene320
    arrs, cam, cfg, _ = make_scene(n=320, seed=3, W=64, H=128)
    names = ("means3d", "scales", "quats", "opacities", "colors", "bg")
    j_img, j_alpha, j_over = jax.jit(partial(j_gs, cam=cam, cfg=cfg._replace(max_dup=1 << 15),
                                             mesh=jmake_mesh(gauss=2)))(
        *[arrs[n] for n in names])
    assert int(j_over) == 0
    for r in group2:
        assert_image_close(r["gs_image"], j_img)


def test_gauss_sharded_budget_overflow_is_counted(group2):
    assert all(int(r["gs_overflow_rows1"]) > 0 for r in group2)


def test_gauss_sharded_grads_match_single_device(group2):
    """means3d, scales, quats, opacities, colors and the mean2d probe."""
    for r in group2:
        assert len(r["gs_grad_err"]) == 6 and (r["gs_grad_err"] < GRAD_TOL).all(), r["gs_grad_err"]


# ------------------------------------------------------------------ data = 2 step


def test_dp_losses_match_jax(group2, dp_ref):
    losses = np.array([float(r["pi_loss"]) for r in group2])
    np.testing.assert_allclose(losses, dp_ref["losses"], rtol=1e-5)
    np.testing.assert_allclose(float(group2[0]["step_loss"]), float(np.mean(dp_ref["losses"])),
                               rtol=1e-5)
    assert all(int(r["pi_overflow"]) == 0 for r in group2)


def test_dp_per_image_grads_match_jax(group2, dp_ref):
    for i, r in enumerate(group2):
        want = dp_ref["grads_b"][i]
        assert len(want) == sum(k.startswith("pi_grad_") for k in r)
        for j, w in enumerate(want):
            assert rel_err(r[f"pi_grad_{j}"], w.numpy()) < GRAD_TOL, j


def test_dp_densification_stats_match_jax(group2, dp_ref):
    new, _ = dp_ref["jax_step"]((0, 0))
    got = CK.state_from_leaves([group2[0][f"step_leaf_{i}"] for i in range(CK.N_STATE_LEAVES)])
    assert int(got.step) == int(dp_ref["state"].step) + 2
    for name in ("xyz_grad_accum", "denom", "max_radii2d"):
        a = getattr(got.gauss_state, name)
        assert float(a.abs().max()) > 0, name
        assert rel_err(a, getattr(new.gauss_state, name)) < GRAD_TOL, name


def _cfg():
    cfg = Config()
    cfg.optimizer.reg_normal_from_iter = 0
    return cfg


@pytest.mark.parametrize("overflow", [(0, 0), (0, 5)])
def test_dp_microsteps_match_jax(dp_ref, overflow):
    """The port's sequential Adam microsteps fed JAX's per-image gradients
    against JAX's make_dp_train_step on the same gradients; with image 1
    overflowing its microstep is rejected in both, the step still +2."""
    new, _ = dp_ref["jax_step"](overflow)
    s = dp_ref["state"]
    leaves_b = [torch.stack([g[j] for g in dp_ref["grads_b"]])
                for j in range(len(dp_ref["grads_b"][0]) - 1)]
    ok_b = torch.tensor(overflow) == 0
    params, opt, step = DP.apply_microsteps(s, dp_ref["like"], leaves_b, ok_b, _cfg())
    want = CK.state_from_leaves(CK.state_leaves(convert.train_state_from_jax(
        new.params, new.gauss_state, new.opt_state.mu, new.opt_state.nu, new.opt_state.count,
        new.step)))
    assert int(step) == int(want.step) == int(s.step) + 2
    assert int(opt.count) == int(want.opt_state.count) == 2 - sum(o > 0 for o in overflow)
    # Per leaf max |delta| / max |ref|: a parameter that an update nearly
    # cancels keeps the operands' last-bit differences, not the result's.
    for got, ref in zip(TS.tree_leaves((params, opt.mu, opt.nu)),
                        TS.tree_leaves((want.params, want.opt_state.mu, want.opt_state.nu))):
        assert rel_err(got.numpy(), ref.numpy()) < 1e-6


def test_dp_overflow_rejects_both_microsteps(group2):
    """With an entry budget far too small every image overflows: parameters and
    Adam state kept, the step +2, the overflow reported."""
    for r in group2:
        assert bool(r["overflow_kept"]) and int(r["overflow_step"]) == 2
        assert int(r["overflow_metric"]) > 0


# ------------------------------------------------------------------ data 2 x gauss 2


def test_fused_step_grads_match_data_only(group4, group2):
    """Per image, the fused data x gauss loss and gradients (pool rows
    concatenated over the gauss ranks) equal the data-only step's."""
    for d in range(2):
        ranks, ref = group4[2 * d:2 * d + 2], group2[d]
        np.testing.assert_allclose([float(r["pi_loss"]) for r in ranks], float(ref["pi_loss"]),
                                   rtol=1e-5)
        for key in (k for k in ref if k.startswith("pi_grad_")):
            want = ref[key]
            parts = [r[key] for r in ranks]
            got = np.concatenate(parts) if parts[0].shape != want.shape else parts[0]
            assert rel_err(got, want) < 1e-5, key


def test_host_replicated_gives_the_full_pool(group4):
    assert all(bool(r["pull_equal"]) for r in group4)


def test_sharded_densify_matches_single_device(group4):
    for r in group4:
        assert bool(r["densify_bitwise"]) and bool(r["densify_report_equal"])
        assert int(r["densify_selected"]) > 0


# ------------------------------------------------------------------ the train CLI


def test_cli_four_ranks_train_densify_save_resume(ranks):
    """`cli.train.main` as 4 ranks (data 2 x gauss 2, --device=cpu) over tcp
    with the JAX multihost test's schedule: densify from 8 every 12, opacity
    reset at 20, 24 iterations with a save and an evaluation, then a resume of
    8 iterations from the checkpoint."""
    out = ranks["out"]
    outs = ranks["cli"].join()
    for r, o in enumerate(outs):
        assert f"[rank {r}] done step 32" in o, o[-2000:]
    for rel in ("point_cloud/iteration_24/point_cloud.ply", "full_state/iteration_24/state.npz",
                "point_cloud/iteration_8/point_cloud.ply", "cameras.json", "cfg_args"):
        assert (out / rel).exists(), rel
    recs = [json.loads(line) for line in open(out / "train_log.jsonl")]
    events = [r["event"] for r in recs if "event" in r]
    for ev in ("densify", "opacity_reset", "save", "evaluate", "resume"):
        assert ev in events, (ev, events)
    # One writer: rank 0's log has each event of each leg once.
    assert events.count("resume") == 1 and events.count("save") == 2
    assert [r["step"] for r in recs if r.get("event") == "resume"] == [24]
    psnrs = [r["psnr"] for r in recs if "psnr" in r]
    assert psnrs and np.isfinite(psnrs).all()
    assert any("train_psnr" in r and np.isfinite(r["train_psnr"]) for r in recs)
    assert all(r["overflow"] == 0 for r in recs if "overflow" in r and "loss" in r)
