"""Parity of the torch port's shading, illumination MLP and serving render with
the JAX package, on the CPU (same numpy inputs through both; the port with
device="cpu"). Shading values are held to 1e-5 absolute; the rendered image to
the JAX package's kernel tolerance (see test_torch_ops.assert_image_close)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import __graft_entry__ as ge
from relightable3dgaussians_w_tpu import renderer as jrenderer
from relightable3dgaussians_w_tpu.models import brdf_lut as jbrdf_lut
from relightable3dgaussians_w_tpu.models import gaussians as jG
from relightable3dgaussians_w_tpu.models import light as jlight
from relightable3dgaussians_w_tpu.models.nets import MLPNet as JMLPNet, init_mlp
from relightable3dgaussians_w_tpu.ops import texture as jtexture
from relightable3dgaussians_w_tpu.ops.rasterize import RasterizerConfig as JRasterizerConfig
from relightable3dgaussians_w_tpu.utils import general as jgeneral
from relightable3dgaussians_w_tpu.utils import graphics as jgraphics
from relightable3dgaussians_w_tpu.utils import sh as jsh

from relightable3dgaussians_w_torch import convert, renderer, synthetic
from relightable3dgaussians_w_torch.models import brdf_lut, gaussians as G, light
from relightable3dgaussians_w_torch.models.nets import MLPNet
from relightable3dgaussians_w_torch.ops import rasterize as trasterize, texture
from relightable3dgaussians_w_torch.utils import general, graphics, sh

from test_torch_ops import assert_image_close, to_t
import _torch_threads

_torch_threads.share_cores()

ATOL = 1e-5


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=atol)


def _unit_dirs(rng, n):
    d = rng.normal(size=(n, 3)).astype(np.float32)
    return d / np.linalg.norm(d, axis=-1, keepdims=True)


@pytest.mark.parametrize("deg", [0, 1, 2, 3, 4, 5])
def test_sh_basis_and_eval_sh(deg):
    rng = np.random.RandomState(deg)
    dirs = _unit_dirs(rng, 64)
    coeffs = rng.normal(size=(64, 3, sh.num_sh_coeffs(deg))).astype(np.float32)
    _close(sh.sh_basis(deg, to_t(dirs)), jsh.sh_basis(deg, jnp.asarray(dirs)))
    _close(sh.eval_sh(deg, to_t(coeffs), to_t(dirs)),
           jsh.eval_sh(deg, jnp.asarray(coeffs), jnp.asarray(dirs)))


def test_gauss_kernel_and_gamma():
    rng = np.random.RandomState(0)
    kr = rng.uniform(0, 1, (50, 1)).astype(np.float32)
    rgb = rng.uniform(-0.2, 1.2, (50, 3)).astype(np.float32)
    _close(sh.gauss_kernel(to_t(kr), 4), jsh.gauss_kernel(jnp.asarray(kr), 4))
    _close(sh.gamma_correction(to_t(rgb)), jsh.gamma_correction(jnp.asarray(rgb)))


def test_graphics_and_general_helpers():
    rng = np.random.RandomState(1)
    q = rng.normal(size=(40, 4)).astype(np.float32)
    s = rng.uniform(0.01, 0.3, (40, 3)).astype(np.float32)
    _close(graphics.quat_to_rotmat(to_t(q)), jgraphics.quat_to_rotmat(jnp.asarray(q)))
    qn = q / np.linalg.norm(q, axis=-1, keepdims=True)
    _close(graphics.covariance_3d(to_t(s), to_t(qn), 1.3),
           jgraphics.covariance_3d(jnp.asarray(s), jnp.asarray(qn), 1.3))
    R = graphics.quat_to_rotmat(to_t(q))
    _close(general.get_minimum_axis(to_t(s), R),
           jgeneral.get_minimum_axis(jnp.asarray(s), jnp.asarray(R.numpy())))
    center = np.array([0.5, -1.0, 2.0], np.float32)
    pts = _unit_dirs(rng, 40) * 20.0 + center
    ang = general.cartesian_to_polar(to_t(pts), to_t(center), 20.0)
    _close(ang, jgeneral.cartesian_to_polar(jnp.asarray(pts), jnp.asarray(center), 20.0))
    _close(general.polar_to_cartesian(ang, to_t(center), 20.0),
           jgeneral.polar_to_cartesian(jnp.asarray(ang.numpy()), jnp.asarray(center), 20.0),
           atol=1e-4)
    np.testing.assert_array_equal(graphics.projection_matrix(0.01, 100.0, 0.9, 0.7),
                                  jgraphics.projection_matrix(0.01, 100.0, 0.9, 0.7))


def test_fg_lut_equals_jax():
    np.testing.assert_array_equal(brdf_lut.get_fg_lut(), jbrdf_lut.get_fg_lut())
    np.testing.assert_array_equal(brdf_lut.get_fg_lut_quad(), jbrdf_lut.get_fg_lut_quad())


def test_bilinear_sample_packed():
    rng = np.random.RandomState(2)
    quad = brdf_lut.get_fg_lut_quad()
    uv = rng.uniform(-0.05, 1.05, (200, 2)).astype(np.float32)
    _close(texture.bilinear_sample_packed(to_t(quad), to_t(uv)),
           jtexture.bilinear_sample_packed(jnp.asarray(quad), jnp.asarray(uv)))


def test_shade_matches_jax():
    rng = np.random.RandomState(3)
    n = 128
    base = rng.normal(0, 0.3, (25, 3)).astype(np.float32)
    pos = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    nrm = _unit_dirs(rng, n)
    albedo = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    view = np.array([0.1, 0.2, -3.0], np.float32)
    kr = rng.uniform(0, 1, (n, 1)).astype(np.float32)
    km = rng.uniform(0, 1, (n, 1)).astype(np.float32)
    for specular in (True, False):
        got = light.shade(to_t(base), 4, to_t(pos), to_t(nrm), to_t(albedo), to_t(view),
                          to_t(kr), to_t(km), specular=specular)
        want = jax.jit(jlight.shade, static_argnums=(1,), static_argnames=("specular",))(
            jnp.asarray(base), 4, jnp.asarray(pos), jnp.asarray(nrm), jnp.asarray(albedo),
            jnp.asarray(view), jnp.asarray(kr), jnp.asarray(km), specular=specular)
        for g, w in zip(got, want):
            _close(g, w)


def _jax_scene(n=200, n_sky=32):
    p, s = ge._synthetic_scene(n=n, n_sky=n_sky)
    tp, ts = convert.gaussians_from_numpy(
        {k: np.asarray(v) for k, v in p._asdict().items()},
        {k: np.asarray(v) for k, v in s._asdict().items()})
    return (p, s), (tp, ts)


def _lighting(seed=1):
    rng = np.random.RandomState(seed)
    envl = rng.uniform(0, 0.5, (25, 3)).astype(np.float32)
    sky = rng.uniform(0, 0.3, (1, 4, 3)).astype(np.float32)
    return envl, sky


def test_synthetic_scene_matches_jax():
    (jp, js), _ = _jax_scene(n=300, n_sky=40)
    tp, ts = synthetic.synthetic_scene(n=300, n_sky=40)
    for name in G.GaussianParams._fields:
        _close(getattr(tp, name), getattr(jp, name), atol=1e-6)
    for name in G.GaussianState._fields:
        np.testing.assert_array_equal(getattr(ts, name).numpy(), np.asarray(getattr(js, name)))
    _close(G.get_xyz(tp, ts), jG.get_xyz(jp, js), atol=2e-5)


@pytest.mark.parametrize("fix_sky", [False, True])
def test_compute_colors_rgb_only(fix_sky):
    (jp, js), (tp, ts) = _jax_scene()
    envl, sky = _lighting()
    cam = ge._camera(64, 64)
    j_rgb, j_n = jax.jit(jrenderer.compute_colors, static_argnums=(4, 5),
                         static_argnames=("fix_sky", "rgb_only"))(
        jp, js, jnp.asarray(envl), jnp.asarray(sky), 4, 1, cam.campos, fix_sky=fix_sky,
        rgb_only=True)
    t_rgb, t_n = renderer.compute_colors(tp, ts, to_t(envl), to_t(sky), 4, 1,
                                         to_t(cam.campos), fix_sky=fix_sky)
    _close(t_rgb, j_rgb)
    _close(t_n, j_n)


def test_mlp_from_flax_params():
    jm = JMLPNet()
    params = jax.jit(lambda k: init_mlp(k, jm))(jax.random.PRNGKey(0))
    e = np.random.RandomState(4).normal(size=(3, 32)).astype(np.float32)
    j_envl, j_sky = jax.jit(lambda p, x: jm.apply({"params": p}, x, deterministic=True))(
        params, jnp.asarray(e))
    tm = MLPNet()
    tm.load_state_dict(convert.mlp_state_dict_from_flax(jax.device_get(params)))
    tm.eval()
    with torch.no_grad():
        t_envl, t_sky = tm(to_t(e))
    assert t_envl.shape == (3, 25, 3) and t_sky.shape == (3, 4, 3)
    _close(t_envl, j_envl)
    _close(t_sky, j_sky)


def test_render_rgb_matches_jax():
    """End to end: ~2k Gaussians plus a sky shell at 64x64."""
    (jp, js), (tp, ts) = _jax_scene(n=2000, n_sky=200)
    envl, sky = _lighting(5)
    W = H = 64
    cam = ge._camera(W, H)
    jcfg = JRasterizerConfig(width=W, height=H, max_dup=1 << 15, lmax_per_tile=2048,
                             tile_chunk=4)
    tcfg = trasterize.RasterizerConfig(width=W, height=H, max_dup=1 << 15)
    bg = np.array([0.1, 0.2, 0.3], np.float32)
    j_img, j_alpha = jax.jit(jrenderer.render_rgb, static_argnums=(5,))(
        jp, js, jnp.asarray(envl), jnp.asarray(sky), cam, jcfg, jnp.asarray(bg))
    t_img, t_aux = renderer.render_rgb(tp, ts, to_t(envl), to_t(sky),
                                       trasterize.CameraMatrices(*[to_t(x) for x in cam]),
                                       tcfg, to_t(bg), device="cpu")
    assert int(t_aux.overflow) == 0 and int(t_aux.num_entries) > 1000
    assert_image_close(t_img.numpy(), np.asarray(j_img))
    assert_image_close(t_aux.alpha.numpy(), np.asarray(j_alpha))
