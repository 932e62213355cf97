"""Row-interval binning of the torch port against the JAX package, on the CPU.

The same numpy scene (tests/test_row_intervals.py's anisotropic scene: one
axis of every Gaussian stretched 6x, so rects overshoot the ellipses) goes
through the JAX functions and the port's (`device="cpu"`, the plain versions of
the CUDA kernels). `row_intervals` (with hand-made edge rows appended) and the
interval binning are integer results and must be equal bitwise; the render
with intervals is held to the JAX test's gates against the rect render (2e-6
absolute on the image, 5e-4 of the largest gradient), and to the JAX
package's kernel tolerance against the JAX render.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from relightable3dgaussians_w_tpu.ops.binning import (
    bin_gaussians_aligned as jbin_aligned, tile_histogram_intervals as jhist_intervals)
from relightable3dgaussians_w_tpu.ops.preprocess import row_intervals as jrow_intervals
from relightable3dgaussians_w_tpu.ops.rasterize import rasterize as jrasterize

from relightable3dgaussians_w_torch.ops import binning, preprocess, rasterize
from relightable3dgaussians_w_torch.ops.cuda import expand as expand_kernel
from relightable3dgaussians_w_torch.ops.cuda import row_intervals as row_intervals_kernel

from _interval_rows import edge_rows
from test_row_intervals import _aniso_scene, _pre as _jax_pre_eager
from test_torch_ops import assert_image_close, to_t, torch_cam
import _torch_threads

_torch_threads.share_cores()

GRAD_TOL = 5e-3


def _port_pre(jp):
    return preprocess.PreprocessOut(*[to_t(x) for x in jp])


# JAX's preprocess, jitted: both packages take its output as their input, so
# its rounding is not under test, and one compile per scene size replaces an
# op-by-op one.
_jax_pre = jax.jit(_jax_pre_eager, static_argnums=(2,))

# JAX's row intervals compiled once, at XLA's optimization level 0, which rounds
# each op on its own as eager JAX and the port do (one compile instead of an
# op-by-op one for every primitive of the chain).
_jrow_intervals_o0 = jax.jit(jrow_intervals, static_argnums=(2,), compiler_options={
    "xla_backend_optimization_level": 0})


def _with_edge_rows(jp, opacities):
    """The scene's JAX PreprocessOut and opacities with the hand-made rows of
    tests/_interval_rows.py appended (their other fields zero)."""
    e = edge_rows()
    k = e["mean2d"].shape[0]
    extra = dict(e, depth=np.zeros(k, np.float32), radius=np.zeros(k, np.int32),
                 cov3d=np.zeros((k, 6), np.float32))
    jp = type(jp)(**{f: jnp.concatenate([getattr(jp, f), jnp.asarray(extra[f])])
                     for f in jp._fields})
    return jp, jnp.concatenate([opacities, jnp.asarray(e["opacity"])])


@pytest.mark.parametrize("seed", [3, 4, 5])
def test_row_intervals_match_jax_bitwise(seed):
    """The plain row intervals equal JAX's bitwise on the scene plus the
    hand-made edge rows (NaN / inf centers, opacity under 1/255, degenerate
    conics, rects taller than 8 rows, of width 0, culled rows, intervals
    clamped at 127, int32 wrap-around); `preprocess.row_intervals` on CPU
    tensors takes the plain route (no kernel launch) and returns its rows as
    int32."""
    arrs, cam, cfg = _aniso_scene(seed=seed)
    jp0 = _jax_pre(arrs, cam, cfg)
    jp, opac = _with_edge_rows(jp0, arrs["opacities"])
    j_counts, j_packed = _jrow_intervals_o0(jp, opac, cfg.tile)
    pre, op = _port_pre(jp), to_t(opac)
    t_counts, t_packed = preprocess.row_intervals_plain(pre, op, cfg.tile)
    assert t_counts.dtype == torch.int32 and t_packed.dtype == torch.float32
    np.testing.assert_array_equal(t_counts.numpy(), np.asarray(j_counts))
    np.testing.assert_array_equal(t_packed.numpy(), np.asarray(j_packed))
    before = row_intervals_kernel.launches
    d_counts, d_packed = preprocess.row_intervals(pre, op, cfg.tile)
    assert row_intervals_kernel.launches == before
    assert d_counts.dtype == torch.int32 and d_packed.dtype == torch.int32
    assert torch.equal(d_counts, t_counts) and torch.equal(d_packed, t_packed.to(torch.int32))
    # The scene cuts entries: the intervals are not all full rects.
    n = jp0.tiles_touched.shape[0]
    assert int(t_counts[:n].sum()) < int(jp0.tiles_touched.sum()) * 0.95


@pytest.mark.parametrize("seed", [3, 4])
def test_interval_binning_matches_jax(seed):
    """Per tile, the port's sorted Gaussian sequence equals the valid entries of
    JAX's bin_gaussians_aligned (its XLA twin of the interval walk), and the
    port's per-tile counts (the sorted keys' searchsorted ranges) equal
    tile_histogram_intervals."""
    arrs, cam, cfg = _aniso_scene(n=300, seed=seed)
    jp = _jax_pre(arrs, cam, cfg)
    iv = jax.jit(jrow_intervals, static_argnums=(2,))(jp, arrs["opacities"], cfg.tile)
    ja = jax.jit(lambda p, i: jbin_aligned(p, cfg.grid_x, cfg.grid_y, 1 << 14, 128,
                                           use_expand_kernel=False, intervals=i))(jp, iv)
    tb = binning.bin_gaussians(_port_pre(jp), cfg.grid_x, cfg.grid_y, 1 << 14,
                               intervals=(to_t(iv[0]), to_t(iv[1])))
    # The port's own int32 rows (`preprocess.row_intervals`) bin the same.
    ib = binning.bin_gaussians(_port_pre(jp), cfg.grid_x, cfg.grid_y, 1 << 14,
                               intervals=preprocess.row_intervals(
                                   _port_pre(jp), to_t(arrs["opacities"]), cfg.tile))
    assert all(torch.equal(a, b) for a, b in zip(ib, tb))
    assert int(tb.num_entries) == int(ja.num_entries) and int(tb.overflow) == 0
    counts = (tb.tile_end - tb.tile_start).numpy()
    np.testing.assert_array_equal(counts, np.asarray(jax.jit(
        jhist_intervals, static_argnums=(2, 3))(jp, iv[1], cfg.grid_x, cfg.grid_y)))
    j_gid, j_start = np.asarray(ja.gauss_id), np.asarray(ja.tile_start)
    t_gid = tb.gauss_id.numpy()
    for t in range(cfg.grid_x * cfg.grid_y):
        s, e = int(tb.tile_start[t]), int(tb.tile_end[t])
        np.testing.assert_array_equal(t_gid[s:e], j_gid[j_start[t]:j_start[t] + counts[t]],
                                      err_msg=f"tile {t}")
    # Against the rect walk: fewer entries, never more per tile.
    rb = binning.bin_gaussians(_port_pre(jp), cfg.grid_x, cfg.grid_y, 1 << 14)
    assert int(tb.num_entries) < int(rb.num_entries)
    assert (counts <= (rb.tile_end - rb.tile_start).numpy()).all()


def _walk(counts, rect_min, rect_w, packed, grid_x):
    """The interval walk written as loops: per Gaussian, the first 8 rows' runs,
    then full-width rows."""
    tiles, ids = [], []
    for i in range(len(counts)):
        out = []
        for j in range(8):
            w_j, txl = int(packed[j, i]) >> 7, int(packed[j, i]) & 127
            out += [(rect_min[i, 1] + j) * grid_x + rect_min[i, 0] + txl + k for k in range(w_j)]
        q = 8
        while len(out) < counts[i]:
            out += [(rect_min[i, 1] + q) * grid_x + rect_min[i, 0] + k for k in range(rect_w[i])]
            q += 1
        tiles += out[:counts[i]]
        ids += [i] * int(counts[i])
    return np.asarray(tiles, np.int64), np.asarray(ids, np.int32)


@pytest.mark.parametrize("max_dup", [256, 40])
def test_interval_expansion_walk(max_dup):
    """The plain interval expansion on hand-made rows: empty rows between
    nonempty ones, a Gaussian taller than 8 tile rows, a culled row (count 0),
    and (max_dup 40) a budget that drops the tail."""
    grid_x = 20
    rect_min = np.array([[2, 1], [0, 0], [5, 3], [1, 2]], np.int32)
    rect_w = np.array([6, 4, 3, 2], np.int32)
    packed = np.zeros((8, 4), np.int32)
    packed[0, 0], packed[2, 0], packed[5, 0] = 1 + 128 * 2, 0 + 128 * 3, 3 + 128 * 1
    packed[:, 1] = [0 + 128 * 4] * 8                 # rows 0-7 full, then 3 tail rows
    packed[1, 2], packed[4, 2] = 2 + 128 * 1, 0 + 128 * 3
    packed[0, 3] = 0 + 128 * 2                       # culled: count forced to 0
    counts = np.array([6, 8 * 4 + 3 * 4, 4, 0], np.int32)
    offsets = np.cumsum(counts) - counts
    rank = np.array([3, 0, 2, 1], np.int64)
    keys, gid = binning.expand_entries_plain(
        to_t(counts), to_t(offsets.astype(np.int64)), to_t(rect_min), to_t(rect_w),
        to_t(rank), grid_x, max_dup, packed=to_t(packed))
    tiles, ids = _walk(counts, rect_min, rect_w, packed, grid_x)
    m = min(len(ids), max_dup)
    np.testing.assert_array_equal(keys[:m].numpy(), (tiles[:m] << 32) | rank[ids[:m]])
    np.testing.assert_array_equal(gid[:m].numpy(), ids[:m])
    assert (keys[m:] == binning.KEY_INVALID).all() and (gid[m:] == 0).all()
    # On the CPU the wrapper is this plain version, with no launch.
    before = expand_kernel.interval_launches
    wk, _ = expand_kernel.expand_entries(
        to_t(counts), to_t(offsets.astype(np.int64)), to_t(rect_min), to_t(rect_w),
        to_t(rank), grid_x, max_dup, packed=to_t(packed))
    assert torch.equal(wk, keys) and expand_kernel.interval_launches == before


def test_interval_render_and_grads():
    """The port's render and gradients with row intervals on vs off (the JAX
    test's gates), and against the JAX render."""
    arrs, cam, cfg = _aniso_scene()
    names = ("means3d", "scales", "quats", "opacities", "colors")
    rng = np.random.RandomState(0)
    wimg = rng.randn(cfg.height, cfg.width, 3).astype(np.float32)

    def run(flag):
        rcfg = rasterize.RasterizerConfig(width=cfg.width, height=cfg.height, max_dup=1 << 16,
                                          row_intervals=flag)
        args = [to_t(arrs[k]).requires_grad_(True) for k in names]
        img, aux = rasterize.rasterize(*args, to_t(arrs["bg"]), torch_cam(cam), rcfg,
                                       device="cpu")
        (torch.sum(img * to_t(wimg)) + torch.sum(aux.alpha)).backward()
        return img.detach(), aux, [a.grad for a in args]

    img0, aux0, g0 = run(False)
    img1, aux1, g1 = run(True)
    assert int(aux1.num_entries) < int(aux0.num_entries)
    assert int(aux0.overflow) == 0 and int(aux1.overflow) == 0
    np.testing.assert_allclose(img1.numpy(), img0.numpy(), atol=2e-6, rtol=0)
    np.testing.assert_allclose(aux1.alpha.detach().numpy(), aux0.alpha.detach().numpy(),
                               atol=2e-6, rtol=0)
    for a, b in zip(g0, g1):
        np.testing.assert_allclose(b.numpy(), a.numpy(), atol=5e-4 * float(a.abs().max()),
                                   rtol=0)

    jcfg = cfg._replace(use_pallas=False)

    def jloss(*a):
        img, aux = jrasterize(*a, arrs["bg"], cam, jcfg)
        return jnp.sum(img * wimg) + jnp.sum(aux.alpha), img

    (_, j_img), j_grads = jax.jit(jax.value_and_grad(jloss, argnums=tuple(range(5)),
                                                     has_aux=True))(*[arrs[k] for k in names])
    assert_image_close(img1.numpy(), np.asarray(j_img))
    for name, got, want in zip(names, g1, j_grads):
        want = np.asarray(want, np.float64)
        err = np.abs(got.numpy() - want).max() / np.abs(want).max()
        assert err < GRAD_TOL, name
