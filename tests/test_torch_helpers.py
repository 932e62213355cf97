"""The port's helper functions against the JAX package's, on the CPU.

The public functions of ported modules that no main path calls: the
rasterizer's preprocess-and-binning query (`ops/rasterize.rasterize_aux`), the
reference's unused loss terms (`utils/losses.py`), the SH / light / sampling
helpers and the rotation and covariance helpers. Same seeded numpy inputs
through both packages; the JAX references are jitted and built once per
module. Tolerances: forward values within 1e-6 of max |ref| (bitwise for
`fibonacci_sphere` and `sym6_to_mat`), input gradients of sum(out * w) within
5e-3 of max |ref| (the kernels' gradient tolerance), which also holds where
each depth loss stops its gradient. `rand_hemisphere_dir` and
`envlight_loss` are fed JAX's own uniform draws and subset indices, taken from
the same key as the JAX call. `rasterize_aux`'s binning equals, bit for bit,
the one `rasterize` builds from its preprocess, and its entry counts equal
JAX's `rasterize_aux` (untightened rects).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from relightable3dgaussians_w_tpu.models import light as jlight
from relightable3dgaussians_w_tpu.ops import preprocess as jpre
from relightable3dgaussians_w_tpu.ops.rasterize import rasterize_aux as jrasterize_aux
from relightable3dgaussians_w_tpu.utils import general as jgeneral
from relightable3dgaussians_w_tpu.utils import graphics as jgraphics
from relightable3dgaussians_w_tpu.utils import losses as jlosses
from relightable3dgaussians_w_tpu.utils import sh as jsh

from relightable3dgaussians_w_torch.models import light
from relightable3dgaussians_w_torch.ops import preprocess as tpre
from relightable3dgaussians_w_torch.ops import rasterize
from relightable3dgaussians_w_torch.utils import general, graphics, losses, sh

from test_rasterize import make_scene
from test_torch_ops import to_t, torch_cam
import _torch_threads

_torch_threads.share_cores()

FWD_TOL = 1e-6
GRAD_TOL = 5e-3
SH_DEG = 4
N_DIRS, SUBSET = 64, 24


def _unit(rng, n):
    v = rng.normal(size=(n, 3))
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


def _inputs():
    """name -> (JAX function, port function, numpy args, indices of the args
    to differentiate). Non-array arguments ride in the functions."""
    rng = np.random.RandomState(0)
    f32 = lambda a: np.asarray(a, np.float32)
    H, W, N = 16, 20, 40
    img = f32(rng.uniform(0, 1, (H, W, 3)))
    gt = f32(rng.uniform(0, 1, (H, W, 3)))
    depth = f32(rng.uniform(1, 5, (H, W)))
    mask = f32(rng.uniform(size=(H, W)) > 0.3)
    base = f32(rng.normal(0, 0.5, ((SH_DEG + 1) ** 2, 3)))
    kr = f32(rng.uniform(0.05, 1.0, (N, 1)))
    pos = f32(rng.uniform(-3, 3, (N, 3)))
    view = f32(rng.uniform(-0.5, 0.5, 3))
    normals = _unit(rng, 300)
    quats = f32(rng.normal(size=(N, 4)))           # not normalized: the raw convention
    scales = f32(rng.uniform(0.01, 0.5, (N, 3)))
    c6 = f32(rng.normal(size=(N, 6)))

    key = jax.random.PRNGKey(3)
    k1, k2 = jax.random.split(key)
    take = min(SUBSET, normals.shape[0])
    idx = np.array(jax.random.choice(k1, normals.shape[0], shape=(take,), replace=False))
    rand = np.array(jax.random.uniform(k2, (take, N_DIRS, 3)))
    hkey = jax.random.PRNGKey(5)
    hrand = np.array(jax.random.uniform(hkey, (30, 16, 3)))

    return {
        "l2_loss": (jlosses.l2_loss, losses.l2_loss, (img, gt), (0,)),
        "zero_one_loss": (jlosses.zero_one_loss, losses.zero_one_loss,
                          (f32(rng.uniform(-0.1, 1.1, (H, W, 3))),), (0,)),
        "smoothing_depth_loss": (jlosses.smoothing_depth_loss, losses.smoothing_depth_loss,
                                 (depth,), (0,)),
        "smoothing_depth_loss_masked": (jlosses.smoothing_depth_loss,
                                        losses.smoothing_depth_loss, (depth, mask), (0,)),
        "sky_depth_loss": (jlosses.sky_depth_loss, losses.sky_depth_loss, (depth, mask), (0,)),
        "envlight_loss": (
            lambda b, n: jlosses.envlight_loss(key, b, SH_DEG, n, N_DIRS, SUBSET),
            lambda b, n: losses.envlight_loss((torch.as_tensor(idx), torch.as_tensor(rand)),
                                              b, SH_DEG, n, N_DIRS, SUBSET),
            (base, normals), (0, 1)),
        "img2mae": (jlosses.img2mae, losses.img2mae, (img, gt), (0,)),
        "img2mae_masked": (jlosses.img2mae, losses.img2mae, (img, gt, mask[..., None]), (0,)),
        "specular_light_sh": (lambda b, k: jlight.specular_light_sh(b, k, SH_DEG),
                              lambda b, k: light.specular_light_sh(b, k, SH_DEG),
                              (base, kr), (0, 1)),
        "sample_illumination": (lambda b, p, v: jlight.sample_illumination(b, SH_DEG, p, v),
                                lambda b, p, v: light.sample_illumination(b, SH_DEG, p, v),
                                (base, pos, view), (0, 1, 2)),
        "rgb_to_sh": (jsh.rgb_to_sh, sh.rgb_to_sh, (img,), (0,)),
        "sh_to_rgb": (jsh.sh_to_rgb, sh.sh_to_rgb, (f32(rng.normal(size=(N, 3))),), (0,)),
        "rand_hemisphere_dir": (lambda n: jgeneral.rand_hemisphere_dir(hkey, 16, n),
                                lambda n: general.rand_hemisphere_dir(torch.as_tensor(hrand),
                                                                      16, n),
                                (normals[:30],), (0,)),
        "quat_to_rotmat_raw": (jgraphics.quat_to_rotmat_raw, graphics.quat_to_rotmat_raw,
                               (quats,), (0,)),
        "build_scaling_rotation": (jgraphics.build_scaling_rotation,
                                   graphics.build_scaling_rotation, (scales, quats), (0, 1)),
        "sym6_to_mat": (jpre.sym6_to_mat, tpre.sym6_to_mat, (c6,), (0,)),
    }


CASES = ["l2_loss", "zero_one_loss", "smoothing_depth_loss", "smoothing_depth_loss_masked",
         "sky_depth_loss", "envlight_loss", "img2mae", "img2mae_masked", "specular_light_sh",
         "sample_illumination", "rgb_to_sh", "sh_to_rgb", "rand_hemisphere_dir",
         "quat_to_rotmat_raw", "build_scaling_rotation", "sym6_to_mat"]
BITWISE = {"sym6_to_mat"}


def _weights(shape, seed):
    return np.random.RandomState(seed).normal(size=shape).astype(np.float32)


@pytest.fixture(scope="module")
def ref():
    """name -> (port function, args, differentiated args, JAX output, JAX
    gradients of sum(out * w), w), each case's value and gradient jitted
    together."""
    cases = _inputs()
    assert list(cases) == CASES
    ws = [_weights(np.shape(jax.eval_shape(jfn, *args)), i)
          for i, (jfn, _, args, _) in enumerate(cases.values())]

    def every_case(all_args):   # one compile for all the cases
        res = []
        for (jfn, _, _, diff), w, a in zip(cases.values(), ws, all_args):
            res.append((jfn(*a), jax.grad(lambda *b: jnp.sum(jfn(*b) * w), argnums=diff)(*a)))
        return res

    got = jax.jit(every_case)([[jnp.asarray(x) for x in c[2]] for c in cases.values()])
    return {name: (tfn, args, diff, np.asarray(y), [np.asarray(x) for x in g], w)
            for (name, (_, tfn, args, diff)), w, (y, g) in zip(cases.items(), ws, got)}


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


@pytest.mark.parametrize("name", CASES)
def test_helper_matches_jax(ref, name):
    tfn, args, diff, want, want_grads, w = ref[name]
    targs = [torch.tensor(a, requires_grad=i in diff) for i, a in enumerate(args)]
    got = tfn(*targs)
    if name in BITWISE:
        np.testing.assert_array_equal(got.detach().numpy(), want)
    else:
        assert _rel(got.detach().numpy(), want) < FWD_TOL, name
    grads = torch.autograd.grad((got * torch.as_tensor(w)).sum(), [targs[i] for i in diff])
    for i, g, gw in zip(diff, grads, want_grads):
        assert _rel(g.numpy(), gw) < GRAD_TOL, (name, i)


@pytest.mark.parametrize("n", [1, 2, 37, 100])
def test_fibonacci_sphere_bitwise(n):
    np.testing.assert_array_equal(general.fibonacci_sphere(n), jgeneral.fibonacci_sphere(n))


def test_depth_losses_stop_gradient_where_jax_does():
    """Without its stop-gradient each depth loss's gradient changes: the
    detach() calls sit where JAX's stop_gradient does (the value above and
    the gradient against JAX hold them there)."""
    rng = np.random.RandomState(1)
    depth = torch.tensor(rng.uniform(1, 5, (12, 12)).astype(np.float32), requires_grad=True)
    mask = torch.as_tensor((rng.uniform(size=(12, 12)) > 0.3).astype(np.float32))
    g_smooth, = torch.autograd.grad(losses.smoothing_depth_loss(depth), [depth])
    g_full, = torch.autograd.grad(torch.mean(torch.abs(depth - losses._box_blur5(depth))),
                                  [depth])
    assert (g_smooth - g_full).abs().max() > 1e-3
    g_sky, = torch.autograd.grad(losses.sky_depth_loss(depth, mask), [depth])
    assert torch.all(g_sky[mask == 1] == 0) and torch.all(g_sky[mask == 0] != 0)


def test_sampling_generators_draw_what_they_are_given():
    """A generator in place of the draws gives the draws that generator makes,
    on its device, in the documented order."""
    normals = torch.as_tensor(_unit(np.random.RandomState(2), 50))
    base = torch.as_tensor(np.random.RandomState(3).normal(0, 0.5, (25, 3)).astype(np.float32))
    g = torch.Generator().manual_seed(11)
    got = losses.envlight_loss(g, base, SH_DEG, normals, 32, 10)
    g = torch.Generator().manual_seed(11)
    idx = torch.randperm(50, generator=g)[:10]
    rand = torch.rand((10, 32, 3), generator=g)
    assert idx.unique().numel() == 10
    assert torch.equal(got, losses.envlight_loss((idx, rand), base, SH_DEG, normals, 32, 10))
    g = torch.Generator().manual_seed(12)
    dirs = general.rand_hemisphere_dir(g, 8, normals)
    g = torch.Generator().manual_seed(12)
    assert torch.equal(dirs, general.rand_hemisphere_dir(torch.rand((50, 8, 3), generator=g),
                                                         8, normals))
    assert dirs.shape == (50, 8, 3)


@pytest.fixture(scope="module")
def aux_scene():
    arrs, cam, cfg, host = make_scene(n=200, seed=4)
    jcfg = cfg._replace(max_tiles_per_gauss=0)
    pre, binning = jax.jit(lambda m, s, q, c: jrasterize_aux(m, s, q, c, jcfg))(
        arrs["means3d"], arrs["scales"], arrs["quats"], cam)
    return host, cam, cfg, (jax.tree.map(np.asarray, pre), jax.tree.map(np.asarray, binning))


def test_rasterize_aux_counts_match_jax(aux_scene):
    host, cam, cfg, (jpre_out, jbin) = aux_scene
    rcfg = rasterize.RasterizerConfig(width=cfg.width, height=cfg.height, max_dup=cfg.max_dup)
    pre, binning = rasterize.rasterize_aux(to_t(host["means"]).float(), to_t(host["scales"]).float(),
                                           to_t(host["quats"]).float(), torch_cam(cam), rcfg,
                                           device="cpu")
    np.testing.assert_array_equal(pre.tiles_touched.numpy(), jpre_out.tiles_touched)
    np.testing.assert_array_equal(pre.radius.numpy(), jpre_out.radius)
    np.testing.assert_array_equal(pre.rect_min.numpy(), jpre_out.rect_min)
    assert int(binning.num_entries) == int(jbin.num_entries) > 0
    assert int(binning.overflow) == int(jbin.overflow) == 0
    # The same entries per tile.
    np.testing.assert_array_equal((binning.tile_end - binning.tile_start).numpy(),
                                  jbin.tile_end - jbin.tile_start)


@pytest.mark.parametrize("row_intervals", [False, True])
def test_rasterize_aux_equals_rasterize_binning(aux_scene, monkeypatch, row_intervals):
    """rasterize_aux's binning is the one `rasterize` builds from its
    preprocess with row intervals off, bit for bit, whatever the config's
    `row_intervals` says: JAX's rasterize_aux walks the untightened rects."""
    host, cam, cfg, _ = aux_scene
    rcfg = rasterize.RasterizerConfig(width=cfg.width, height=cfg.height, max_dup=cfg.max_dup)
    means, scales, quats, op, colors, bg = (to_t(host[k]).float() for k in
                                            ("means", "scales", "quats", "opac", "colors", "bg"))
    pre, binning = rasterize.rasterize_aux(means, scales, quats, torch_cam(cam),
                                           rcfg._replace(row_intervals=row_intervals),
                                           device="cpu")
    seen, real_bin = [], rasterize.bin_gaussians
    monkeypatch.setattr(rasterize, "bin_gaussians",
                        lambda *a, **k: seen.append(real_bin(*a, **k)) or seen[-1])
    rasterize.rasterize(None, None, None, op, colors, bg, torch_cam(cam), rcfg, device="cpu",
                        pre=pre)
    want, = seen
    assert int(binning.num_entries) > 0
    for a, b in zip(binning, want):
        assert torch.equal(a, b)


def test_rasterize_aux_cov3d_precomp():
    """A precomputed covariance gives the preprocess of the scales and quats it
    came from, as in JAX."""
    arrs, cam, cfg, host = make_scene(n=60, seed=5)
    rcfg = rasterize.RasterizerConfig(width=cfg.width, height=cfg.height, max_dup=cfg.max_dup)
    means, scales, quats = (to_t(host[k]).float() for k in ("means", "scales", "quats"))
    cov = graphics.covariance_3d(scales, quats)
    a_pre, a_bin = rasterize.rasterize_aux(means, scales, quats, torch_cam(cam), rcfg, device="cpu")
    b_pre, b_bin = rasterize.rasterize_aux(means, None, None, torch_cam(cam), rcfg,
                                           cov3d_precomp=cov, device="cpu")
    for a, b in zip(a_pre + a_bin, b_pre + b_bin):
        assert torch.equal(a, b)
