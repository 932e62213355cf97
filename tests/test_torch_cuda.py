"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These need an NVIDIA GPU and skip elsewhere. The file imports no JAX, so it runs
on a machine with only PyTorch installed; there, skip the JAX test harness:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import numpy as np
import pytest
import torch

from relightable3dgaussians_w_torch import synthetic
from relightable3dgaussians_w_torch.models import gaussians as G
from relightable3dgaussians_w_torch.ops import binning, composite, preprocess
from relightable3dgaussians_w_torch.ops.cuda import expand as expand_kernel
from relightable3dgaussians_w_torch.ops.cuda import tile_composite as composite_kernel

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _image_close(got, want):
    err = (got.double() - want.double()).abs().flatten().cpu()
    assert float((err > 1e-3).double().mean()) < 1e-3, float(err.max())
    assert float(err.median()) < 1e-5


def _frame(dev, n=20_000, res=256, channels=3):
    p, s = synthetic.synthetic_scene(n=n, n_sky=n // 10, device=dev)
    cam = synthetic.camera(res, res, device=dev)
    opa = G.get_opacity(p, s)[:, 0]
    pre = preprocess.preprocess(G.get_xyz(p, s), G.get_scaling(p), G.get_rotation(p),
                                cam.viewmat, cam.projmat, cam.tan_fovx, cam.tan_fovy,
                                res, res, 16, active=s.alive, opacities=opa)
    colors = torch.as_tensor(np.random.RandomState(0).uniform(
        0, 1, (opa.shape[0], channels)).astype(np.float32), device=dev)
    return pre, opa, colors, (res + 15) // 16


def test_expand_kernel_matches_plain(dev):
    pre, _, _, gx = _frame(dev)
    n = pre.depth.shape[0]
    counts = pre.tiles_touched.contiguous()
    offsets = torch.cumsum(counts, 0) - counts
    rank = torch.empty(n, dtype=torch.int64, device=dev)
    rank[torch.argsort(pre.depth, stable=True)] = torch.arange(n, device=dev)
    rect_w = torch.clamp_min(pre.rect_max[:, 0] - pre.rect_min[:, 0], 1).int().contiguous()
    total = int(counts.sum())
    for max_dup in (total + 1000, total // 2):     # with and without overflow
        args = (counts, offsets, pre.rect_min.contiguous(), rect_w, rank, gx, max_dup)
        before = expand_kernel.launches
        keys, gid = expand_kernel.expand_entries(*args)
        torch.cuda.synchronize()
        assert expand_kernel.launches == before + 1
        p_keys, p_gid = binning.expand_entries_plain(*args)
        assert torch.equal(keys, p_keys) and torch.equal(gid, p_gid)


@pytest.mark.parametrize("channels", [3, 13])
def test_composite_kernel_matches_plain(dev, channels):
    pre, opa, colors, gx = _frame(dev, channels=channels)
    b = binning.bin_gaussians(pre, gx, gx, int(pre.tiles_touched.sum()) + 1024)
    feat = torch.cat([pre.mean2d, pre.conic, opa[:, None], colors], -1)[b.gauss_id.long()]
    bg = torch.linspace(0.1, 0.9, channels, device=dev)
    before = composite_kernel.launches
    k_rgb, k_tfin = composite_kernel.composite_forward(feat.contiguous(), b.tile_start,
                                                       b.tile_end, bg, gx, gx)
    torch.cuda.synchronize()
    assert composite_kernel.launches == before + 1
    p_rgb, p_tfin = composite.composite_forward(feat, b.tile_start, b.tile_end, bg, gx, gx)
    assert torch.isfinite(k_rgb).all()
    _image_close(k_rgb, p_rgb)
    _image_close(k_tfin, p_tfin)


def test_wrappers_reject_bad_inputs(dev):
    feat = torch.zeros(8, 9, device=dev)
    ts = torch.zeros(4, dtype=torch.int64, device=dev)
    with pytest.raises(ValueError):
        composite_kernel.composite_forward(feat, ts.int(), ts.int(), torch.zeros(3, device=dev),
                                           2, 2)
    with pytest.raises(ValueError):
        composite_kernel.composite_forward(feat, ts, ts, torch.zeros(3, device=dev), 2, 2,
                                           tile=8)
    counts = torch.zeros(4, dtype=torch.int32, device=dev)
    with pytest.raises(TypeError):
        expand_kernel.expand_entries(counts, counts, torch.zeros(4, 2, dtype=torch.int32,
                                     device=dev), counts, ts, 2, 16)
