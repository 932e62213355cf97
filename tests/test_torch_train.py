"""The torch port's training slice against the JAX package, on the CPU.

The same numpy inputs (made from a seed) go through the JAX function and its
port counterpart (`device="cpu"`, which takes the plain PyTorch versions of the
CUDA kernels): the compositor backward, the rasterizer's gradients (with the
mean2d probe), the segment sum behind the gather, the losses, and one whole
training step, whose random draws are recreated from the JAX step's key.
Gradients are held to the JAX package's own kernel tolerance
(tests/test_pallas_composite.py): max |delta| / max |ref| < 5e-3 per group.
"""

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

import __graft_entry__ as ge
from relightable3dgaussians_w_tpu import renderer as jrenderer
from relightable3dgaussians_w_tpu import train_step as JTS
from relightable3dgaussians_w_tpu.models import gaussians as jG
from relightable3dgaussians_w_tpu.models.nets import MLPNet as JMLPNet, init_mlp as jinit_mlp
from relightable3dgaussians_w_tpu.ops import composite as jcomposite
from relightable3dgaussians_w_tpu.ops.binning import bin_gaussians as jbin_gaussians
from relightable3dgaussians_w_tpu.ops.pallas import segment_sum as jsegment_sum
from relightable3dgaussians_w_tpu.ops.rasterize import (
    RasterizerConfig as JRasterizerConfig, _gather_features as j_gather_features,
    rasterize as jrasterize)
from relightable3dgaussians_w_tpu.utils import graphics as jgraphics
from relightable3dgaussians_w_tpu.utils import losses as jlosses

from relightable3dgaussians_w_torch import convert, renderer, train_step as TS
from relightable3dgaussians_w_torch.config import Config
from relightable3dgaussians_w_torch.models import gaussians as G
from relightable3dgaussians_w_torch.models.nets import MLPNet
from relightable3dgaussians_w_torch.ops import composite, rasterize, segment_sum
from relightable3dgaussians_w_torch.ops.cuda import segment_sum as segment_sum_kernel
from relightable3dgaussians_w_torch.ops.cuda import tile_composite as composite_kernel
from relightable3dgaussians_w_torch.utils import graphics, losses

from test_rasterize import make_scene
from test_torch_ops import _jax_pre, to_t, torch_cam, torch_rcfg
from test_torch_render import _jax_scene, _lighting
import test_train_step
from test_train_step import build_setup

GRAD_TOL = 5e-3


def rel_err(got, want):
    """max |got - want| / max |want| (the JAX package's gradient tolerance)."""
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


# ------------------------------------------------------------ compositor backward


@pytest.mark.parametrize("channels", [3, 13])
def test_composite_backward_matches_jax(channels):
    arrs, cam, cfg, _ = make_scene(n=200, seed=2, channels=channels)

    @partial(jax.jit, static_argnums=2)
    def entries(arrs, cam, cfg):   # the JAX rasterizer's compositor inputs, compiled once
        jp = _jax_pre(arrs, cam, cfg)
        jb = jbin_gaussians(jp, cfg.grid_x, cfg.grid_y, cfg.max_dup)
        return jb, j_gather_features(jp, jb, arrs["opacities"], arrs["colors"], None)

    jb, feat = entries(arrs, cam, cfg)
    lmax = int(np.max(np.asarray(jb.tile_end) - np.asarray(jb.tile_start)))
    ccfg = jcomposite.CompositeConfig(grid_x=cfg.grid_x, grid_y=cfg.grid_y, tile=cfg.tile,
                                      channels=channels, lmax_per_tile=lmax, tile_chunk=4)
    T, P = cfg.grid_x * cfg.grid_y, cfg.tile ** 2
    rng = np.random.RandomState(channels)
    g_tiles = rng.randn(T, P, channels).astype(np.float32)
    g_tfin = rng.randn(T, P).astype(np.float32)
    j_dfeat, j_dbg = jax.jit(jcomposite.composite_backward, static_argnums=4)(
        feat, jb.tile_start, jb.tile_end, arrs["bg"], ccfg, jnp.asarray(g_tiles),
        jnp.asarray(g_tfin))
    args = (to_t(feat), to_t(jb.tile_start).long(), to_t(jb.tile_end).long(), to_t(arrs["bg"]))
    t_dfeat, t_dbg = composite.composite_backward(*args, cfg.grid_x, cfg.grid_y,
                                                  to_t(g_tiles), to_t(g_tfin))
    j_dfeat = np.asarray(j_dfeat)
    for name, cols in (("mean2d", slice(0, 2)), ("conic", slice(2, 5)),
                       ("opacity", slice(5, 6)), ("colors", slice(6, None))):
        assert rel_err(t_dfeat[:, cols], j_dfeat[:, cols]) < GRAD_TOL, name
    assert rel_err(t_dbg, j_dbg) < 1e-5
    assert float(np.abs(j_dfeat[:, 0:2]).max()) > 0
    # On the CPU the kernel's wrapper is this plain version, with no launch.
    before = composite_kernel.backward_launches
    rgb, tfin = composite.composite_forward(*args, cfg.grid_x, cfg.grid_y)
    w_dfeat, _ = composite_kernel.composite_backward(*args, rgb, tfin, to_t(g_tiles),
                                                     to_t(g_tfin), cfg.grid_x, cfg.grid_y)
    assert torch.equal(w_dfeat, t_dfeat)
    assert composite_kernel.backward_launches == before


def test_rasterize_grads_match_jax():
    """Gradients of a weighted image + alpha loss with respect to the six
    rasterizer inputs and the mean2d probe, as tests/test_pallas_composite.py
    holds the JAX kernels to them."""
    arrs, cam, cfg, host = make_scene(n=200, seed=2)
    rng = np.random.RandomState(0)
    wimg = rng.randn(host["H"], host["W"], 3).astype(np.float32)
    walpha = rng.randn(host["H"], host["W"]).astype(np.float32)
    names = ("means3d", "scales", "quats", "opacities", "colors", "bg")
    n = host["means"].shape[0]

    def jloss(*a):
        img, aux = jrasterize(*a[:6], cam, cfg, mean2d_probe=a[6])
        return jnp.sum(img * wimg) + jnp.sum(aux.alpha * walpha)

    j_grads = jax.jit(jax.grad(jloss, argnums=tuple(range(7))))(
        *[arrs[k] for k in names], jnp.zeros((n, 2), jnp.float32))
    t_args = [to_t(arrs[k]).requires_grad_(True) for k in names]
    probe = torch.zeros(n, 2, requires_grad=True)
    img, aux = rasterize.rasterize(*t_args, torch_cam(cam), torch_rcfg(cfg), device="cpu",
                                   mean2d_probe=probe)
    (torch.sum(img * to_t(wimg)) + torch.sum(aux.alpha * to_t(walpha))).backward()
    for name, t, jg in zip(names + ("mean2d_probe",), t_args + [probe], j_grads):
        assert float(np.abs(np.asarray(jg)).max()) > 0, name
        assert rel_err(t.grad, jg) < GRAD_TOL, name


# ------------------------------------------------------------ segment sum and gather


@pytest.mark.parametrize("n,d,f,skewed", [(700, 8192, 9, False), (520, 4096, 3, True)])
def test_segment_sum_matches_jax(n, d, f, skewed):
    """Against the JAX twin and the Pallas kernel in interpret mode, at
    tests/test_segment_sum.py's sizes (one hot segment plus empties when
    skewed)."""
    rng = np.random.RandomState(1 if skewed else 0)
    if skewed:
        ids = np.where(rng.rand(d) < 0.7, 3, rng.randint(0, n, d)).astype(np.int32)
        rows = rng.randn(f, d).astype(np.float32)
    else:
        rows = rng.randn(f, d).astype(np.float32)
        ids = rng.randint(0, n, d).astype(np.int32)
    j_rows = [jnp.asarray(r) for r in rows]
    want_jnp = np.asarray(jsegment_sum.segment_sum_rows_jnp(j_rows, jnp.asarray(ids), n))
    want_pallas = np.asarray(jsegment_sum.segment_sum_rows(
        j_rows, jnp.asarray(ids), n, block=128, interpret=True))[:n, :f]
    got = segment_sum.segment_sum_rows_plain(to_t(rows.T.copy()), to_t(ids), n)
    np.testing.assert_allclose(got.numpy(), want_jnp, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), want_pallas, rtol=1e-5, atol=1e-5)
    before = segment_sum_kernel.launches
    wrapped = segment_sum_kernel.segment_sum_rows(to_t(rows.T.copy()), to_t(ids), n)
    assert torch.equal(wrapped, got) and segment_sum_kernel.launches == before


def test_gather_rows_grad_matches_jax():
    rng = np.random.RandomState(2)
    n, d, f_used, f_pad = 300, 4096, 9, 16
    pack = np.zeros((n, f_pad), np.float32)
    pack[:, :f_used] = rng.randn(n, f_used)
    gid = rng.randint(0, n, d).astype(np.int32)
    cot = rng.randn(f_pad, d).astype(np.float32)
    cot[f_used:] = 0.0
    j_grad = jax.grad(lambda p: jnp.vdot(
        jsegment_sum.gather_rows_t(p, jnp.asarray(gid), n, f_used, True), jnp.asarray(cot)))(
        jnp.asarray(pack))
    t_pack = to_t(pack[:, :f_used]).requires_grad_(True)
    layout = segment_sum.ids_layout(segment_sum.entry_ids(to_t(gid), torch.tensor(d), n), n)
    rows = segment_sum.gather_rows(t_pack, to_t(gid), *layout)
    np.testing.assert_array_equal(rows.detach().numpy(), pack[gid, :f_used])
    torch.sum(rows * to_t(cot[:f_used].T.copy())).backward()
    np.testing.assert_allclose(t_pack.grad.numpy(), np.asarray(j_grad)[:, :f_used],
                               rtol=1e-5, atol=1e-5)

    # Slots past num_valid (the entry budget's unused slots) drop out of the sum.
    cut = d // 3
    cot_cut = cot.copy()
    cot_cut[:, cut:] = 0.0
    j_grad = jax.grad(lambda p: jnp.vdot(
        jsegment_sum.gather_rows_t(p, jnp.asarray(gid), n, f_used, True), jnp.asarray(cot_cut)))(
        jnp.asarray(pack))
    t_pack.grad = None
    layout = segment_sum.ids_layout(segment_sum.entry_ids(to_t(gid), torch.tensor(cut), n), n)
    rows = segment_sum.gather_rows(t_pack, to_t(gid), *layout)
    torch.sum(rows * to_t(cot[:f_used].T.copy())).backward()
    np.testing.assert_allclose(t_pack.grad.numpy(), np.asarray(j_grad)[:, :f_used],
                               rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------ AOV channels


@pytest.mark.parametrize("debug", [False, True])
def test_compute_colors_aov_matches_jax(debug):
    """The fused AOV channels (13, or 21 with debug) of foreground and sky rows."""
    (jp, js), (tp, ts) = _jax_scene()
    envl, sky = _lighting()
    cam = ge._camera(64, 64)
    j_c, j_n = jax.jit(jrenderer.compute_colors, static_argnums=(4, 5),
                       static_argnames="debug")(jp, js, jnp.asarray(envl), jnp.asarray(sky), 4,
                                                1, cam.campos, debug=debug)
    t_c, t_n = renderer.compute_colors(tp, ts, to_t(envl), to_t(sky), 4, 1, to_t(cam.campos),
                                       debug=debug, rgb_only=False)
    assert t_c.shape == (tp.xyz.shape[0], 21 if debug else 13)
    np.testing.assert_allclose(t_c.numpy(), np.asarray(j_c), rtol=0, atol=1e-5)
    np.testing.assert_allclose(t_n.numpy(), np.asarray(j_n), rtol=0, atol=1e-5)


# ------------------------------------------------------------ losses


def _port_value_and_grads(t_fn, *arrays):
    t_args = [to_t(a).requires_grad_(True) for a in arrays]
    t_val = t_fn(*t_args)
    t_val.backward()
    return float(t_val.detach()), [t.grad for t in t_args]


def _check(t_fn, j_out, *arrays):
    """The port's value and gradients of a scalar loss of the float arrays
    against JAX's (`j_out` = (value, grads))."""
    t_val, t_grads = _port_value_and_grads(t_fn, *arrays)
    np.testing.assert_allclose(t_val, float(j_out[0]), rtol=1e-5)
    for tg, jg in zip(t_grads, j_out[1], strict=True):
        assert rel_err(tg, jg) < GRAD_TOL


def test_losses_match_jax():
    rng = np.random.RandomState(3)
    C, H, W = 3, 24, 40
    img1 = rng.uniform(0, 1, (C, H, W)).astype(np.float32)
    img2 = rng.uniform(0, 1, (C, H, W)).astype(np.float32)
    mask = (rng.rand(1, H, W) < 0.7).astype(np.float32)
    key = jax.random.PRNGKey(7)
    sh_env = rng.normal(0, 0.5, (25, 3)).astype(np.float32)
    n = 300
    scaling = rng.uniform(0.01, 0.3, (n, 3)).astype(np.float32)
    radii = rng.randint(0, 4, n).astype(np.int32)
    is_sky = rng.rand(n) < 0.2
    depths = rng.uniform(1, 30, n).astype(np.float32)
    depth = rng.uniform(2, 4, (H, W)).astype(np.float32)
    wn = rng.randn(H, W, 3).astype(np.float32)
    a = np.deg2rad(20.0)
    c2w = np.eye(4, dtype=np.float32)
    c2w[0, 0], c2w[0, 2], c2w[2, 0], c2w[2, 2] = np.cos(a), np.sin(a), -np.sin(a), np.cos(a)
    c2w[:3, 3] = [0.3, -0.2, 1.0]
    tan = np.float32(0.6)

    @jax.jit
    def jax_losses(img1, img2, jm, sh_env, scaling, depths, depth):
        """Every JAX value and gradient below, compiled once."""
        vg = lambda f, *a: jax.value_and_grad(f, argnums=tuple(range(len(a))))(*a)
        out = {}
        for name, m in (("plain", None), ("masked", jm)):
            out["ssim_" + name] = vg(lambda a, b: jlosses.ssim(a, b, mask=m), img1, img2)
            out["l1_" + name] = vg(lambda a, b: jlosses.l1_loss(a, b, mask=m), img1, img2)
            out["psnr_" + name] = jlosses.psnr(img1, img2, m)
        out["envl"] = vg(lambda s: jlosses.envl_sh_loss(key, s, 4), sh_env)
        out["min_scale"] = vg(lambda s: jlosses.min_scale_loss(s, jnp.asarray(radii),
                                                               jnp.asarray(is_sky)), scaling)
        out["depth"] = vg(lambda d: jlosses.depth_loss_gaussians(d, jnp.asarray(is_sky),
                                                                 jnp.asarray(radii > 0)), depths)
        out["normal"] = jgraphics.depth_to_normal(depth, jnp.asarray(c2w), tan, tan)
        out["normal_loss"] = vg(lambda d: jnp.sum(jgraphics.depth_to_normal(
            d, jnp.asarray(c2w), tan, tan) * wn), depth)
        return out

    j = jax_losses(*[jnp.asarray(x) for x in (img1, img2, mask, sh_env, scaling, depths, depth)])
    tm = to_t(mask)
    for t_mask, name in ((None, "plain"), (tm, "masked")):
        _check(lambda a, b: losses.ssim(a, b, mask=t_mask), j["ssim_" + name], img1, img2)
        _check(lambda a, b: losses.l1_loss(a, b, mask=t_mask), j["l1_" + name], img1, img2)
        np.testing.assert_allclose(float(losses.psnr(to_t(img1), to_t(img2), t_mask)),
                                   float(j["psnr_" + name]), rtol=1e-5)

    # R+ constraint with the JAX loss's own sample directions.
    dirs = to_t(jax.random.uniform(key, (10, 3), minval=-1.0, maxval=1.0))
    _check(lambda s: losses.envl_sh_loss(dirs, s, 4), j["envl"], sh_env)
    _check(lambda s: losses.min_scale_loss(s, to_t(radii), to_t(is_sky)), j["min_scale"], scaling)
    _check(lambda d: losses.depth_loss_gaussians(d, to_t(is_sky), to_t(radii > 0)), j["depth"],
           depths)

    # Depth-derived normals, weighted so the gradient reaches every pixel.
    np.testing.assert_allclose(
        graphics.depth_to_normal(to_t(depth), to_t(c2w), to_t(tan), to_t(tan)).numpy(),
        np.asarray(j["normal"]), rtol=1e-5, atol=1e-6)
    _check(lambda d: torch.sum(graphics.depth_to_normal(d, to_t(c2w), to_t(tan), to_t(tan))
                               * to_t(wn)), j["normal_loss"], depth)


# ------------------------------------------------------------ one training step


@pytest.fixture(scope="module")
def step_setup():
    """tests/test_train_step.py's scene at step 1 (the normal and sky-depth
    terms on), the fused JAX loss and gradients on the jnp path, the port's
    copy of the state and the JAX key's draws."""
    with pytest.MonkeyPatch.context() as mp:   # flax's init op by op takes ~4 s
        mp.setattr(test_train_step, "init_mlp", lambda key, mlp: jax.jit(
            lambda k: jinit_mlp(k, mlp))(key))
        tstate, _, cam, gt, sky, occ, jcfg = build_setup()
    tstate = tstate._replace(step=jnp.asarray(1))
    jmlp = JMLPNet(sh_degree_envl=4, sh_degree_sky=1)
    jrcfg = JRasterizerConfig(width=64, height=64, max_dup=1 << 14, max_tiles_per_gauss=32,
                              lmax_per_tile=256, tile_chunk=4)
    key = jax.random.PRNGKey(42)
    n = tstate.gauss_state.alive.shape[0]
    f = jax.jit(jax.value_and_grad(partial(JTS.forward_loss, mlp=jmlp, cfg=jcfg, rcfg=jrcfg),
                                   argnums=(0, 2), has_aux=True))
    (j_loss, _), (j_grads, j_probe) = f(
        tstate.params, tstate.gauss_state, jnp.zeros((n, 2)), cam=cam, gt_image=gt,
        sky_mask=sky, occluders_mask=occ, cam_uid=jnp.asarray(0), key=key, step=tstate.step,
        bg_color=jnp.zeros(3))

    # The step's draws from its key, as the JAX step makes them.
    k_noise, k_drop, k_envl = jax.random.split(key, 3)
    e = tstate.params["embeddings"][0][None]
    _, inter = jmlp.apply({"params": tstate.params["mlp"]}, e, deterministic=False,
                          rngs={"dropout": k_drop}, capture_intermediates=True,
                          mutable=["intermediates"])
    keep = np.asarray(inter["intermediates"]["Dropout_0"]["__call__"][0]) != 0
    draws = TS.StepDraws(to_t(jax.random.normal(k_noise, (25, 3)) * 0.025), to_t(keep),
                         to_t(jax.random.uniform(k_envl, (10, 3), minval=-1.0, maxval=1.0)))

    g = jax.device_get
    state = convert.train_state_from_jax(g(tstate.params), g(tstate.gauss_state),
                                         g(tstate.opt_state.mu), g(tstate.opt_state.nu),
                                         g(tstate.opt_state.count), g(tstate.step))
    cfg = Config()
    cfg.optimizer.reg_normal_from_iter = jcfg.optimizer.reg_normal_from_iter
    inputs = (torch_cam(cam), to_t(gt), to_t(sky), to_t(occ), 0, draws, torch.zeros(3),
              MLPNet(), cfg, rasterize.RasterizerConfig(width=64, height=64, max_dup=1 << 14))
    return dict(tstate=tstate, j_loss=float(j_loss), j_grads=g(j_grads), j_probe=g(j_probe),
                state=state, inputs=inputs)


def test_train_step_grads_match_jax(step_setup):
    s = step_setup
    loss, aux, grads, probe_grad = TS.loss_and_grads(s["state"], *s["inputs"], device="cpu")
    np.testing.assert_allclose(float(loss), s["j_loss"], rtol=1e-5)
    assert int(aux["overflow"]) == 0
    jg = s["j_grads"]
    for name in G.GaussianParams._fields:
        assert rel_err(getattr(grads["gaussians"], name), getattr(jg["gaussians"], name)) \
            < GRAD_TOL, name
    t_mlp = convert.mlp_params_to_flax(grads["mlp"])
    for layer in t_mlp:
        for leaf in ("kernel", "bias"):
            assert rel_err(t_mlp[layer][leaf], jg["mlp"][layer][leaf]) < GRAD_TOL, (layer, leaf)
    assert rel_err(grads["embeddings"], jg["embeddings"]) < GRAD_TOL
    assert rel_err(probe_grad, s["j_probe"]) < GRAD_TOL


def test_train_step_updates_match_jax(step_setup):
    """The whole port step: its densification statistics against the JAX
    package's from the JAX gradients, and its Adam, fed the JAX gradient tree,
    against optax.scale_by_adam over two updates (bias correction at counts 1
    and 2)."""
    s = step_setup
    tstate, jg = s["tstate"], s["j_grads"]
    new, aux = TS.train_step(s["state"], *s["inputs"], device="cpu")
    assert int(new.step) == 2 and int(new.opt_state.count) == 1
    np.testing.assert_allclose(float(aux.loss), s["j_loss"], rtol=1e-5)
    j_stats = jG.add_densification_stats(tstate.gauss_state,
                                         jnp.asarray(s["j_probe"]) * jnp.asarray([32.0, 32.0]),
                                         aux.visibility.numpy(), aux.radii.numpy())
    for name in ("xyz_grad_accum", "denom", "max_radii2d"):
        got = getattr(new.gauss_state, name)
        assert float(got.abs().max()) > 0, name
        assert rel_err(got, getattr(j_stats, name)) < GRAD_TOL, name

    adam = optax.scale_by_adam(b1=0.9, b2=0.999, eps=1e-15)
    j_opt = tstate.opt_state
    t_opt = s["state"].opt_state
    t_grads = convert.train_state_from_jax(jg, tstate.gauss_state, jg, jg, 0, 0).params
    for _ in range(2):
        j_upd, j_opt = adam.update(jg, j_opt)
        t_upd, t_opt = TS.adam_update(t_grads, t_opt)
        for t_tree, j_tree in ((t_upd, j_upd), (t_opt.mu, j_opt.mu), (t_opt.nu, j_opt.nu)):
            j_tree = convert.train_state_from_jax(jax.device_get(j_tree), tstate.gauss_state,
                                                  jg, jg, 0, 0).params
            for t_leaf, j_leaf in zip(TS.tree_leaves(t_tree), TS.tree_leaves(j_tree)):
                np.testing.assert_allclose(t_leaf.numpy(), j_leaf.numpy(), rtol=1e-6,
                                           atol=1e-30)
    assert int(t_opt.count) == int(j_opt.count) == 2


def test_overflow_rejects_the_update(step_setup):
    """With an entry budget far too small the step keeps params, Adam moments,
    Adam count and densification statistics, and advances only `step`."""
    s = step_setup
    inputs = list(s["inputs"])
    inputs[-1] = inputs[-1]._replace(max_dup=64)
    state = s["state"]
    new, aux = TS.train_step(state, *inputs, device="cpu")
    assert int(aux.overflow) > 0
    assert int(new.step) == int(state.step) + 1
    for got, want in zip(TS.tree_leaves((new.params, new.opt_state, new.gauss_state)),
                         TS.tree_leaves((state.params, state.opt_state, state.gauss_state))):
        assert torch.equal(got, want)


def test_train_steps_reduce_loss(step_setup):
    """12 port steps on the CPU make progress on a fixed target, as
    tests/test_train_step.py asks of the JAX step; the opacity reset then
    clamps opacities and zeroes their moments as the JAX reset does."""
    s = step_setup
    state = s["state"]
    mlp, cfg = s["inputs"][7], s["inputs"][8]
    gen = torch.Generator().manual_seed(42)
    losses_ = []
    for _ in range(12):
        state, aux = TS.train_step(state, *s["inputs"][:5], TS.make_draws(gen, mlp, cfg),
                                   *s["inputs"][6:], device="cpu")
        losses_.append(float(aux.loss))
        assert np.isfinite(losses_[-1]) and int(aux.overflow) == 0
    assert losses_[-1] < losses_[0], losses_
    for leaf in TS.tree_leaves(state.params):
        assert torch.isfinite(leaf).all()

    reset = TS.reset_opacity_step(state)
    g_np = {k: v.numpy() for k, v in state.params["gaussians"]._asdict().items()}
    j_params, _ = jG.reset_opacity(jG.GaussianParams(**g_np), ())
    np.testing.assert_allclose(reset.params["gaussians"].opacity.numpy(),
                               np.asarray(j_params.opacity), rtol=1e-6, atol=1e-6)
    assert float(reset.opt_state.mu["gaussians"].opacity.abs().max()) == 0.0
    assert float(reset.opt_state.nu["gaussians"].opacity.abs().max()) == 0.0
    alive = state.gauss_state.alive
    assert float(torch.sigmoid(reset.params["gaussians"].opacity)[alive].max()) <= 0.0101
