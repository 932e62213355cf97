"""The gather's gradient through the binning's segment layout, on the CPU.

The rasterizer's gather (`ops/segment_sum.gather_rows`) sums its entry-row
gradients over the layout the binning hands it (`BinningOut.seg_bounds`,
`.slot_pos`) instead of sorting the entry ids. Held here, on a small
rasterized scene whose entry budget overflows, with culled Gaussians and one
Gaussian of hundreds of entries:
- against the JAX package's `gather_rows_t` VJP (its Pallas segment sum in
  interpret mode), within 1e-5;
- against the general route `segment_sum_rows(rows, ids, n)` on the same rows;
- the layout against what a stable sort of the entry ids gives;
- the backward sorts and searches nothing.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from relightable3dgaussians_w_tpu.ops.pallas import segment_sum as jsegment_sum

from relightable3dgaussians_w_torch import synthetic
from relightable3dgaussians_w_torch.ops import binning, preprocess, segment_sum
from relightable3dgaussians_w_torch.ops.cuda import segment_sum as segment_sum_kernel
import _torch_threads

_torch_threads.share_cores()

RES = 320          # 20 x 20 tiles
MAX_DUP = 4096     # a multiple of the JAX kernel's 4096-entry DMA step
F_USED, F_PAD = 9, 16


@pytest.fixture(scope="module")
def scene():
    """(PreprocessOut, BinningOut) of 600 Gaussians in front of the camera: one
    large one (index 1), a tenth culled by `active`, and more entries than the
    budget holds."""
    rng = np.random.RandomState(0)
    n = 600
    means = np.stack([rng.uniform(-1.5, 1.5, n), rng.uniform(-1.5, 1.5, n),
                      rng.uniform(3.0, 6.0, n)], 1).astype(np.float32)
    scales = rng.uniform(0.02, 0.25, (n, 3)).astype(np.float32)
    means[1], scales[1] = (0.0, 0.0, 4.0), (1.2, 1.0, 0.5)
    quats = rng.randn(n, 4).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=1, keepdims=True)
    active = rng.rand(n) > 0.1
    active[1] = True
    t = torch.as_tensor
    cam = synthetic.camera(RES, RES)
    pre = preprocess.preprocess(t(means), t(scales), t(quats), cam.viewmat, cam.projmat,
                                cam.tan_fovx, cam.tan_fovy, RES, RES, 16, active=t(active),
                                opacities=torch.full((n,), 0.5))
    b = binning.bin_gaussians(pre, RES // 16, RES // 16, MAX_DUP)
    return pre, b


def test_scene_has_overflow_empties_and_a_large_gaussian(scene):
    pre, b = scene
    counts = b.seg_bounds.diff()
    assert int(b.overflow) > 0 and int(b.num_entries) > MAX_DUP
    assert int((pre.tiles_touched == 0).sum()) >= 10
    assert int(counts[1]) >= 200                      # kept whole, inside the budget
    assert int(counts.sum()) == MAX_DUP and int((counts == 0).sum()) > 50


def test_binning_layout_equals_sort_of_ids(scene):
    """`seg_bounds` and `slot_pos` are what a stable sort of the entry ids
    gives (`ids_layout`), and `layout_ids` inverts them to those ids."""
    pre, b = scene
    n = pre.depth.shape[0]
    ids = segment_sum.entry_ids(b.gauss_id, b.num_entries, n)
    bounds, order = segment_sum.ids_layout(ids, n)
    assert torch.equal(b.seg_bounds, bounds)
    assert torch.equal(b.slot_pos[: int(bounds[-1])], order[: int(bounds[-1])])
    assert torch.equal(b.slot_pos.sort().values, torch.arange(MAX_DUP, dtype=torch.int32))
    assert torch.equal(segment_sum.layout_ids(b.seg_bounds, b.slot_pos, MAX_DUP), ids.long())


def _pack_and_cotangent(n, seed):
    rng = np.random.RandomState(seed)
    pack = np.zeros((n, F_PAD), np.float32)
    pack[:, :F_USED] = rng.randn(n, F_USED)
    cot = np.zeros((F_PAD, MAX_DUP), np.float32)
    cot[:F_USED] = rng.randn(F_USED, MAX_DUP)
    return pack, cot


def test_gather_rows_binned_grad_matches_jax(scene):
    pre, b = scene
    n = pre.depth.shape[0]
    pack, cot = _pack_and_cotangent(n, 1)
    gid = b.gauss_id.numpy()
    j_grad = jax.grad(lambda p: jnp.vdot(
        jsegment_sum.gather_rows_t(p, jnp.asarray(gid), n, F_USED, True), jnp.asarray(cot)))(
        jnp.asarray(pack))
    t_pack = torch.as_tensor(pack[:, :F_USED]).requires_grad_(True)
    rows = segment_sum.gather_rows(t_pack, b.gauss_id, b.seg_bounds, b.slot_pos)
    np.testing.assert_array_equal(rows.detach().numpy(), pack[gid, :F_USED])
    torch.sum(rows * torch.as_tensor(cot[:F_USED].T.copy())).backward()
    want = np.asarray(j_grad)[:, :F_USED]
    np.testing.assert_allclose(t_pack.grad.numpy(), want, rtol=1e-5, atol=1e-5)
    assert not t_pack.grad[pre.tiles_touched == 0].any()


@pytest.mark.parametrize("features", [9, 19])
def test_binned_route_equals_general_route(scene, features):
    """The layout route and `segment_sum_rows(rows, ids, n)` on the same rows
    give the same bits, and neither launches a kernel on the CPU."""
    pre, b = scene
    n = pre.depth.shape[0]
    rows = torch.as_tensor(np.random.RandomState(features).randn(MAX_DUP, features)
                           .astype(np.float32))
    before = segment_sum_kernel.launches
    binned = segment_sum_kernel.segment_sum_ordered(rows, b.seg_bounds, b.slot_pos)
    general = segment_sum_kernel.segment_sum_rows(
        rows, segment_sum.entry_ids(b.gauss_id, b.num_entries, n), n)
    assert torch.equal(binned, general) and segment_sum_kernel.launches == before
    np.testing.assert_allclose(binned.numpy(), segment_sum.segment_sum_rows_plain(
        rows, segment_sum.entry_ids(b.gauss_id, b.num_entries, n), n).numpy(), rtol=0, atol=0)


def test_gather_backward_sorts_nothing(scene, monkeypatch):
    """`_GatherRows.backward` on the rasterizer's path calls no sort and no
    binary search: both raise while the backward runs."""
    pre, b = scene
    n = pre.depth.shape[0]
    pack, cot = _pack_and_cotangent(n, 2)
    t_pack = torch.as_tensor(pack[:, :F_USED]).requires_grad_(True)
    rows = segment_sum.gather_rows(t_pack, b.gauss_id, b.seg_bounds, b.slot_pos)
    loss = torch.sum(rows * torch.as_tensor(cot[:F_USED].T.copy()))

    def refuse(*args, **kwargs):
        raise AssertionError("the gather's backward sorted or searched")

    for name in ("sort", "argsort", "searchsorted"):
        monkeypatch.setattr(torch, name, refuse)
        monkeypatch.setattr(torch.Tensor, name, refuse, raising=False)
    loss.backward()
    monkeypatch.undo()
    ids = segment_sum.entry_ids(b.gauss_id, b.num_entries, n)
    want = segment_sum.segment_sum_rows_plain(
        torch.as_tensor(cot[:F_USED].T.copy()), ids, n)
    assert torch.equal(t_pack.grad, want)
