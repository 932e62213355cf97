"""Parity of the torch port's rasterizer ops with the JAX package, on the CPU.

The same numpy inputs go through the JAX function and its port counterpart
(`device="cpu"`, which takes the plain PyTorch versions of the CUDA kernels).
Integer outputs (preprocess rects, binning order) must be equal; images are held
to the tolerance the JAX package holds its own Pallas kernels to
(tests/test_pallas_composite.py): under 0.1% of pixels off by more than 1e-3 and
a median error under 1e-5.
"""

import numpy as np
import jax
import pytest
import torch

from relightable3dgaussians_w_tpu.ops import composite as jcomposite
from relightable3dgaussians_w_tpu.ops.binning import bin_gaussians as jbin_gaussians
from relightable3dgaussians_w_tpu.ops.preprocess import preprocess as jpreprocess
from relightable3dgaussians_w_tpu.ops.rasterize import (
    _gather_features as j_gather_features, rasterize as jrasterize)

from relightable3dgaussians_w_torch.ops import binning, composite, preprocess, rasterize
from relightable3dgaussians_w_torch.ops.cuda import expand as expand_kernel
from relightable3dgaussians_w_torch.ops.cuda import tile_composite as composite_kernel

from test_rasterize import make_scene
import _torch_threads

_torch_threads.share_cores()


def to_t(x):
    return torch.as_tensor(np.array(x))


def torch_cam(cam):
    return rasterize.CameraMatrices(*[to_t(x) for x in cam])


def torch_rcfg(cfg):
    return rasterize.RasterizerConfig(width=cfg.width, height=cfg.height, tile=cfg.tile,
                                      max_dup=cfg.max_dup, skip_alpha=cfg.skip_alpha)


def assert_image_close(got, want):
    """The JAX package's kernel tolerance (tests/test_pallas_composite.py)."""
    err = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    assert (err > 1e-3).mean() < 1e-3, err.max()
    assert np.median(err) < 1e-5, np.median(err)


def _jax_pre(arrs, cam, cfg, skip_alpha=1.0 / 255.0):
    return jpreprocess(arrs["means3d"], arrs["scales"], arrs["quats"], cam.viewmat,
                       cam.projmat, cam.tan_fovx, cam.tan_fovy, cfg.width, cfg.height,
                       cfg.tile, opacities=arrs["opacities"], skip_alpha=skip_alpha)


# JAX's binning, jitted: its outputs are integers (a sort, sums and searches),
# the same bits compiled or op by op, and one compile replaces an op-by-op one.
_jbin = jax.jit(jbin_gaussians, static_argnums=(1, 2, 3))


@pytest.mark.parametrize("seed,skip_alpha", [(0, 1.0 / 255.0), (1, 1.0 / 255.0), (2, 1.0 / 16.0)])
def test_preprocess_matches_jax(seed, skip_alpha):
    arrs, cam, cfg, _ = make_scene(n=300, seed=seed)
    jp = _jax_pre(arrs, cam, cfg, skip_alpha)
    tc = torch_cam(cam)
    tp = preprocess.preprocess(
        to_t(arrs["means3d"]), to_t(arrs["scales"]), to_t(arrs["quats"]), tc.viewmat,
        tc.projmat, tc.tan_fovx, tc.tan_fovy, cfg.width, cfg.height, cfg.tile,
        opacities=to_t(arrs["opacities"]), skip_alpha=skip_alpha)
    for name in ("radius", "tiles_touched", "rect_min", "rect_max"):
        np.testing.assert_array_equal(getattr(tp, name).numpy(), np.asarray(getattr(jp, name)),
                                      err_msg=name)
    for name in ("mean2d", "conic", "depth", "cov3d"):
        np.testing.assert_allclose(getattr(tp, name).numpy(), np.asarray(getattr(jp, name)),
                                   rtol=1e-5, atol=1e-5, err_msg=name)
    assert int(tp.tiles_touched.sum()) > 0


@pytest.mark.parametrize("seed", [0, 1])
def test_binning_matches_jax(seed):
    """Fed the same PreprocessOut, the port's expand -> sort -> ranges gives
    every tile the same Gaussian sequence as the JAX bin_gaussians."""
    arrs, cam, cfg, _ = make_scene(n=300, seed=seed)
    jp = _jax_pre(arrs, cam, cfg)
    jb = _jbin(jp, cfg.grid_x, cfg.grid_y, cfg.max_dup)
    tb = binning.bin_gaussians(preprocess.PreprocessOut(*[to_t(x) for x in jp]),
                               cfg.grid_x, cfg.grid_y, cfg.max_dup)
    assert int(tb.num_entries) == int(jb.num_entries) > 0
    assert int(tb.overflow) == int(jb.overflow) == 0
    np.testing.assert_array_equal(tb.tile_start.numpy(), np.asarray(jb.tile_start))
    np.testing.assert_array_equal(tb.tile_end.numpy(), np.asarray(jb.tile_end))
    js, je, jg = (np.asarray(a) for a in (jb.tile_start, jb.tile_end, jb.gauss_id))
    tg = tb.gauss_id.numpy()
    for t in range(cfg.grid_x * cfg.grid_y):
        np.testing.assert_array_equal(tg[js[t]:je[t]], jg[js[t]:je[t]], err_msg=f"tile {t}")


def _expand_oracle(counts, rect_min, rect_w, rank, grid_x, max_dup):
    keys = np.full(max_dup, np.iinfo(np.int64).max, np.int64)
    gid = np.zeros(max_dup, np.int32)
    slot = 0
    for i in range(len(counts)):
        for s in range(counts[i]):
            if slot < max_dup:
                q, r = divmod(s, int(rect_w[i]))
                tile = (int(rect_min[i, 1]) + q) * grid_x + int(rect_min[i, 0]) + r
                keys[slot] = (tile << 32) | int(rank[i])
                gid[slot] = i
            slot += 1
    return keys, gid


@pytest.mark.parametrize("max_dup", [512, 64])
def test_expand_plain_matches_numpy_oracle(max_dup):
    """The plain expansion's (key, gid) before the sort, including the budget
    clamp; a CPU tensor takes the plain version, with no kernel launch."""
    rng = np.random.RandomState(0)
    n, grid_x = 40, 9
    w = rng.randint(1, 4, n).astype(np.int32)
    h = rng.randint(0, 3, n)
    counts = (w * h).astype(np.int32)
    rect_min = np.stack([rng.randint(0, grid_x - 3, n), rng.randint(0, 6, n)], -1).astype(np.int32)
    rank = rng.permutation(n).astype(np.int64)
    offsets = (np.cumsum(counts) - counts).astype(np.int64)
    want = _expand_oracle(counts, rect_min, w, rank, grid_x, max_dup)
    args = (to_t(counts), to_t(offsets), to_t(rect_min), to_t(w), to_t(rank), grid_x, max_dup)
    before = expand_kernel.launches
    for keys, gid in (binning.expand_entries_plain(*args), expand_kernel.expand_entries(*args)):
        np.testing.assert_array_equal(keys.numpy(), want[0])
        np.testing.assert_array_equal(gid.numpy(), want[1])
    assert expand_kernel.launches == before


def _jax_entries(seed, n=300):
    arrs, cam, cfg, _ = make_scene(n=n, seed=seed)
    jp = _jax_pre(arrs, cam, cfg)
    jb = _jbin(jp, cfg.grid_x, cfg.grid_y, cfg.max_dup)
    feat = j_gather_features(jp, jb, arrs["opacities"], arrs["colors"], None)
    return arrs, cfg, jb, feat


@pytest.mark.parametrize("budget", [1 << 24, 256 * 64])
def test_composite_forward_matches_jax(budget):
    """Plain composite over the flat sorted entry list vs the JAX compositor;
    the small budget splits the tiles into several padded batches."""
    arrs, cfg, jb, feat = _jax_entries(seed=0)
    lmax = int(np.max(np.asarray(jb.tile_end) - np.asarray(jb.tile_start)))
    ccfg = jcomposite.CompositeConfig(grid_x=cfg.grid_x, grid_y=cfg.grid_y, tile=cfg.tile,
                                      channels=3, lmax_per_tile=max(lmax, 1), tile_chunk=4)
    j_rgb, j_tfin = jcomposite.composite_forward(feat, jb.tile_start, jb.tile_end,
                                                 arrs["bg"], ccfg)
    t_rgb, t_tfin = composite.composite_forward(
        to_t(feat), to_t(jb.tile_start).long(), to_t(jb.tile_end).long(), to_t(arrs["bg"]),
        cfg.grid_x, cfg.grid_y, cfg.tile, budget=budget)
    assert_image_close(t_rgb.numpy(), np.asarray(j_rgb))
    assert_image_close(t_tfin.numpy(), np.asarray(j_tfin))
    # The CPU wrapper of the CUDA compositor is this plain version.
    before = composite_kernel.launches
    w_rgb, w_tfin = composite_kernel.composite_forward(
        to_t(feat), to_t(jb.tile_start).long(), to_t(jb.tile_end).long(), to_t(arrs["bg"]),
        cfg.grid_x, cfg.grid_y, cfg.tile)
    np.testing.assert_array_equal(w_rgb.numpy(), t_rgb.numpy())
    assert composite_kernel.launches == before


def _port_rasterize(arrs, cam, cfg):
    return rasterize.rasterize(
        *[to_t(arrs[k]) for k in ("means3d", "scales", "quats", "opacities", "colors", "bg")],
        torch_cam(cam), torch_rcfg(cfg), device="cpu")


@pytest.mark.parametrize("seed,n", [(0, 200), (1, 300)])
def test_rasterize_matches_jax(seed, n):
    arrs, cam, cfg, _ = make_scene(n=n, seed=seed)
    j_img, j_aux = jax.jit(jrasterize, static_argnames=("cfg",))(**arrs, cam=cam, cfg=cfg)
    t_img, t_aux = _port_rasterize(arrs, cam, cfg)
    assert t_img.shape == (cfg.height, cfg.width, 3)
    assert int(t_aux.overflow) == 0
    assert int(t_aux.num_entries) == int(j_aux.num_entries)
    np.testing.assert_array_equal(t_aux.radii.numpy(), np.asarray(j_aux.radii))
    assert_image_close(t_img.numpy(), np.asarray(j_img))
    assert_image_close(t_aux.alpha.numpy(), np.asarray(j_aux.alpha))


def test_rasterize_matches_jax_pallas_interpret():
    """Against the JAX Pallas path, run in interpret mode as
    tests/test_pallas_composite.py runs it."""
    arrs, cam, cfg, _ = make_scene(n=300, seed=0)
    cfg_p = cfg._replace(use_pallas=True, pallas_interpret=True, pallas_chunk=128)
    j_img, j_aux = jax.jit(jrasterize, static_argnames=("cfg",))(**arrs, cam=cam, cfg=cfg_p)
    t_img, t_aux = _port_rasterize(arrs, cam, cfg)
    assert_image_close(t_img.numpy(), np.asarray(j_img))
    assert_image_close(t_aux.alpha.numpy(), np.asarray(j_aux.alpha))


@pytest.mark.parametrize("field", ["packed_rgb", "row_intervals"])
def test_unported_options_raise(field):
    """Both options are ported. packed_rgb (a serving option) renders what the
    exact path renders on the dequantized colors, bit for bit; row_intervals
    renders what the rects render, from no more entries."""
    arrs, cam, cfg, _ = make_scene(n=20, seed=0)
    rcfg = torch_rcfg(cfg)._replace(**{field: True})
    args = [to_t(arrs[k]) for k in ("means3d", "scales", "quats", "opacities", "colors", "bg")]
    if field == "packed_rgb":
        img, _ = rasterize.rasterize(*args, torch_cam(cam), rcfg, device="cpu")
        deq = composite.unpack_rb(*composite.pack_rb(args[4]))
        ref, _ = rasterize.rasterize(*args[:4], deq, args[5], torch_cam(cam), torch_rcfg(cfg),
                                     device="cpu")
        assert torch.equal(img, ref)
        return
    img, aux = rasterize.rasterize(*args, torch_cam(cam), rcfg, device="cpu")
    ref, ref_aux = rasterize.rasterize(*args, torch_cam(cam), torch_rcfg(cfg), device="cpu")
    np.testing.assert_allclose(img.numpy(), ref.numpy(), atol=2e-6, rtol=0)
    assert 0 < int(aux.num_entries) <= int(ref_aux.num_entries)
