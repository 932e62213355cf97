"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These need an NVIDIA GPU and skip elsewhere. The file imports no JAX, so it runs
on a machine with only PyTorch installed; there, skip the JAX test harness:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import numpy as np
import pytest
import torch

from relightable3dgaussians_w_torch import synthetic, train_step as TS
from relightable3dgaussians_w_torch.config import Config
from relightable3dgaussians_w_torch.models import gaussians as G
from relightable3dgaussians_w_torch.models.nets import MLPNet
from relightable3dgaussians_w_torch.ops import binning, composite, preprocess, rasterize, segment_sum
from relightable3dgaussians_w_torch.ops.cuda import expand as expand_kernel
from relightable3dgaussians_w_torch.ops.cuda import segment_sum as segment_sum_kernel
from relightable3dgaussians_w_torch.ops.cuda import tile_composite as composite_kernel
from relightable3dgaussians_w_torch.scripts import selfcheck_train as SC

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


def _frame(dev, n=20_000, res=256, channels=3, min_opacity=0.0):
    p, s = synthetic.synthetic_scene(n=n, n_sky=n // 10, device=dev)
    cam = synthetic.camera(res, res, device=dev)
    opa = torch.clamp_min(G.get_opacity(p, s)[:, 0], min_opacity)
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


def test_expand_kernel_on_hand_made_counts(dev):
    """Kernel A against its plain version, bitwise: a third of the Gaussians
    with no entry, one rect of 64 x 64 tiles, small rects around it, and
    budgets above the total, cutting the large rect's run in the middle and
    cutting a run of small rects."""
    rng = np.random.RandomState(3)
    n, gx = 6000, 80
    w = rng.randint(1, 6, n)
    h = rng.randint(1, 6, n)
    w[n // 3], h[n // 3] = 64, 64
    x0, y0 = rng.randint(0, gx - 64, n), rng.randint(0, gx - 64, n)
    counts = np.where(rng.rand(n) < 1 / 3, 0, w * h)
    counts[n // 3] = 64 * 64
    offsets = np.cumsum(counts) - counts
    t = lambda a, dt: torch.as_tensor(np.ascontiguousarray(a), dtype=dt, device=dev)
    args = (t(counts, torch.int32), t(offsets, torch.int64),
            t(np.stack([x0, y0], 1), torch.int32), t(w, torch.int32),
            t(rng.permutation(n), torch.int64), gx)
    total, big = int(counts.sum()), int(offsets[n // 3])
    for max_dup in (total + 5000, big + 2048 + 7, big - 3, 4096):
        before = expand_kernel.launches
        keys, gid = expand_kernel.expand_entries(*args, max_dup)
        torch.cuda.synchronize()
        assert expand_kernel.launches == before + 1
        p_keys, p_gid = binning.expand_entries_plain(*args, max_dup)
        assert torch.equal(keys, p_keys) and torch.equal(gid, p_gid), max_dup


def _frame_rows(dev, channels, min_opacity=0.0):
    """A frame's sorted entry rows: (feat, tile_start, tile_end, grid_x, grid_y)."""
    pre, opa, colors, gx = _frame(dev, channels=channels, min_opacity=min_opacity)
    b = binning.bin_gaussians(pre, gx, gx, int(pre.tiles_touched.sum()) + 1024)
    feat = torch.cat([pre.mean2d, pre.conic, opa[:, None], colors], -1)[b.gauss_id.long()]
    return feat.contiguous(), b.tile_start, b.tile_end, gx, gx


@pytest.mark.parametrize("channels", [3, 13, 21, 51])
def test_composite_kernel_matches_plain(dev, channels):
    feat, ts, te, gx, gy = _frame_rows(dev, channels)
    bg = torch.linspace(0.1, 0.9, channels, device=dev)
    before = composite_kernel.launches
    k_rgb, k_tfin = composite_kernel.composite_forward(feat, ts, te, bg, gx, gy)
    torch.cuda.synchronize()
    assert composite_kernel.launches == before + 1
    p_rgb, p_tfin = composite.composite_forward(feat, ts, te, bg, gx, gy)
    assert torch.isfinite(k_rgb).all()
    _image_close(k_rgb, p_rgb)
    _image_close(k_tfin, p_tfin)


def test_packed_kernel_equals_kernel_on_dequantized_colors(dev):
    """Kernel B' on packed rows equals kernel B on the dequantized colors, bit for
    bit, and its plain version within the image tolerance."""
    pre, opa, colors, gx = _frame(dev)
    colors = colors * 3.0 - 0.5                      # past both ends of [0, 1]
    b = binning.bin_gaussians(pre, gx, gx, int(pre.tiles_touched.sum()) + 1024)
    rb, g = composite.pack_rb(colors)
    head = torch.cat([pre.mean2d, pre.conic, opa[:, None]], -1)
    packed = torch.cat([head, rb[:, None], g[:, None]], -1)[b.gauss_id.long()].contiguous()
    exact = torch.cat([head, composite.unpack_rb(rb, g)], -1)[b.gauss_id.long()].contiguous()
    bg = torch.tensor([0.1, 0.5, 0.9], device=dev)
    before = composite_kernel.packed_launches
    k_rgb, k_tfin = composite_kernel.composite_forward_packed(packed, b.tile_start, b.tile_end,
                                                              bg, gx, gx)
    torch.cuda.synchronize()
    assert composite_kernel.packed_launches == before + 1
    e_rgb, e_tfin = composite_kernel.composite_forward(exact, b.tile_start, b.tile_end, bg, gx, gx)
    assert torch.equal(k_rgb, e_rgb) and torch.equal(k_tfin, e_tfin)
    p_rgb, p_tfin = composite.composite_forward_packed(packed, b.tile_start, b.tile_end, bg, gx, gx)
    _image_close(k_rgb, p_rgb)
    _image_close(k_tfin, p_tfin)


def test_channel_limits_raise(dev):
    """The forward kernel takes up to 64 channels and the backward up to 32; past
    them the wrappers raise ValueError instead of launching."""
    ts = torch.zeros(4, dtype=torch.int64, device=dev)
    with pytest.raises(ValueError, match="1..64"):
        composite_kernel.composite_forward(torch.zeros(8, 6 + 65, device=dev), ts, ts,
                                           torch.zeros(65, device=dev), 2, 2)
    feat = torch.zeros(8, 6 + 33, device=dev)
    tiles, tfin = torch.zeros(4, 256, 33, device=dev), torch.zeros(4, 256, device=dev)
    with pytest.raises(ValueError, match="1..32"):
        composite_kernel.composite_backward(feat, ts, ts, torch.zeros(33, device=dev), tiles,
                                            tfin, tiles, tfin, 2, 2)


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
    tiles, tfin = torch.zeros(4, 256, 3, device=dev), torch.zeros(4, 256, device=dev)
    with pytest.raises(ValueError):   # g_tiles with the wrong channel count
        composite_kernel.composite_backward(feat, ts, ts, torch.zeros(3, device=dev), tiles,
                                            tfin, torch.zeros(4, 256, 2, device=dev), tfin, 2, 2)
    with pytest.raises(ValueError):   # ids of another length
        segment_sum_kernel.segment_sum_rows(feat, ts, 4)


def _rel(got, want):
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


def _hand_made_rows(dev, channels):
    """Three 16x16 tiles of made-up entry rows: (feat, tile_start, tile_end, 3, 1).

    Tile 0 holds 600 faint entries near its left edge: more than two staging
    batches of either kernel (256 rows in the forward, 64 in the backward),
    with a ragged tail; its left pixels terminate at different depths, its
    right ones not at all. Tile 1
    is empty. Tile 2 holds 300 entries whose first three cover the tile at
    opacity 0.99, so every pixel terminates within the first batch and the
    later entries are never reached."""
    rng = np.random.RandomState(channels)
    counts = (600, 0, 300)

    def rows(n, x, sigma, opacity):
        mean = np.stack([rng.uniform(*x, n), rng.uniform(-4, 20, n)], -1)
        s = rng.uniform(*sigma, (n, 2))
        rho = rng.uniform(-0.5, 0.5, n)
        det = (1 - rho ** 2) * (s[:, 0] * s[:, 1]) ** 2
        conic = np.stack([s[:, 1] ** 2, -rho * s[:, 0] * s[:, 1], s[:, 0] ** 2], -1) / det[:, None]
        return np.concatenate([mean, conic, opacity[:, None],
                               rng.uniform(0, 1, (n, channels))], -1)

    t2 = rows(counts[2], (28, 52), (3, 10), rng.uniform(0.05, 0.6, counts[2]))
    t2[:3, :2], t2[:3, 2:5], t2[:3, 5] = (40, 8), (1e-4, 0, 1e-4), 0.99
    t0 = rows(counts[0], (-6, 4), (3, 8), rng.uniform(0.004, 0.08, counts[0]))
    feat = np.concatenate([t0, t2]).astype(np.float32)
    ends = np.cumsum(counts)
    as_dev = lambda a: torch.as_tensor(a, device=dev)
    return as_dev(feat), as_dev(ends - counts), as_dev(ends), 3, 1


def _backward_cotangents(rgb, tfin, seed):
    gen = torch.Generator(device=rgb.device).manual_seed(seed)
    return (torch.randn(rgb.shape, generator=gen, device=rgb.device),
            torch.randn(tfin.shape, generator=gen, device=rgb.device))


def _hold_backward(feat, ts, te, gx, gy, seed):
    """Kernel C against the plain backward on one set of entry rows: per
    gradient group (the JAX package's kernel tolerance), bitwise equal over two
    launches, and zero on exactly the rows the plain version leaves zero.
    Returns (kernel d_feat, plain d_feat, final transmittance)."""
    C = feat.shape[1] - 6
    bg = torch.linspace(0.1, 0.9, C, device=feat.device)
    rgb, tfin = composite_kernel.composite_forward(feat, ts, te, bg, gx, gy)
    g_rgb, g_tfin = _backward_cotangents(rgb, tfin, seed)
    args = (feat, ts, te, bg, rgb, tfin, g_rgb, g_tfin, gx, gy)
    before = composite_kernel.backward_launches
    d_k, dbg_k = composite_kernel.composite_backward(*args)
    d_k2, _ = composite_kernel.composite_backward(*args)
    torch.cuda.synchronize()
    assert composite_kernel.backward_launches == before + 2
    assert torch.equal(d_k, d_k2)
    d_p, dbg_p = composite.composite_backward(feat, ts, te, bg, gx, gy, g_rgb, g_tfin)
    assert torch.isfinite(d_k).all()
    for name, cols in (("mean2d", slice(0, 2)), ("conic", slice(2, 5)),
                       ("opacity", slice(5, 6)), ("colors", slice(6, None))):
        assert _rel(d_k[:, cols], d_p[:, cols]) < 5e-3, name
    assert _rel(dbg_k, dbg_p) < 1e-5
    assert torch.equal((d_k == 0).all(1), (d_p == 0).all(1))
    return d_k, d_p, tfin


@pytest.mark.parametrize("channels", [3, 13, 21])
def test_composite_backward_kernel_matches_plain(dev, channels):
    """Kernel C against the plain backward on a frame (`_hold_backward`)."""
    _hold_backward(*_frame_rows(dev, channels), seed=channels)


@pytest.mark.parametrize("channels", [3, 13, 21])
def test_composite_backward_zero_rows_match_plain(dev, channels):
    """Where the plain backward leaves an entry row exactly zero (no pixel
    blends it: all its pairs skipped, or every pixel terminated before it),
    kernel C's row is exactly zero too, and nowhere else: a predicate moved by
    FMA contraction or by the staging would show here. Opacities of at least
    0.9 make most pixels terminate, so both kinds of zero rows are common."""
    feat, ts, te, gx, gy = _frame_rows(dev, channels, min_opacity=0.9)
    d_k, d_p, tfin = _hold_backward(feat, ts, te, gx, gy, seed=100 + channels)
    assert 0 < int((d_p == 0).all(1).sum()) < feat.shape[0]
    assert float((tfin < 1e-3).double().mean()) > 0.5


@pytest.mark.parametrize("channels", [3, 13, 21, 51])
def test_composite_kernels_on_hand_made_tiles(dev, channels):
    """B against its plain version on `_hand_made_rows` (more than two staging
    batches with a ragged tail, an empty tile, a tile whose pixels all
    terminate in the first batch); C too, up to its 32 channels."""
    feat, ts, te, gx, gy = _hand_made_rows(dev, channels)
    bg = torch.linspace(0.1, 0.9, channels, device=dev)
    k_rgb, k_tfin = composite_kernel.composite_forward(feat, ts, te, bg, gx, gy)
    p_rgb, p_tfin = composite.composite_forward(feat, ts, te, bg, gx, gy)
    torch.cuda.synchronize()
    _image_close(k_rgb, p_rgb)
    _image_close(k_tfin, p_tfin)
    assert torch.equal(k_rgb[1], bg.expand(256, channels)) and bool((k_tfin[1] == 1).all())
    assert bool((k_tfin[2] < 0.02).all()) and 0 < int((k_tfin[0] < 1e-3).sum()) < 256
    if channels <= composite_kernel.MAX_BACKWARD_CHANNELS:
        d_k = _hold_backward(feat, ts, te, gx, gy, seed=200 + channels)[0]
        assert not bool(d_k[600:900].any(1)[64:].any())   # never reached
        assert bool(d_k[:600].any(1)[512:].any())         # the ragged tail's rows


def test_segment_sum_kernel_matches_plain(dev):
    """Kernel D against index_add_ (the order of summation only) and bitwise
    equal over two launches, on a frame's entry ids and on the binning's
    layout of the same entries (the rasterizer's route), which gives the same
    bits."""
    pre, _, _, gx = _frame(dev)
    b = binning.bin_gaussians(pre, gx, gx, int(pre.tiles_touched.sum()) + 1024)
    n = pre.depth.shape[0]
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = torch.randn((b.gauss_id.shape[0], 19), generator=gen, device=dev)
    ids = segment_sum.entry_ids(b.gauss_id, b.num_entries, n)   # unused slots dropped
    before = segment_sum_kernel.launches
    got = segment_sum_kernel.segment_sum_rows(rows, ids, n)
    got2 = segment_sum_kernel.segment_sum_rows(rows, ids, n)
    binned = segment_sum_kernel.segment_sum_ordered(rows, b.seg_bounds, b.slot_pos)
    torch.cuda.synchronize()
    assert segment_sum_kernel.launches == before + 3
    assert torch.equal(got, got2) and torch.equal(binned, got)
    want = segment_sum.segment_sum_rows_plain(rows, ids, n)
    assert _rel(got, want) < 1e-5


@pytest.mark.parametrize("overflow", [False, True])
def test_permute_kernel_matches_plain(dev, overflow):
    """The binning's permutation kernel P against its plain version (the gather
    gid[perm] and a scatter of the inverse permutation), bitwise, on a frame's
    expansion and sort, with and without a budget overflow."""
    pre, _, _, gx = _frame(dev)
    n = pre.depth.shape[0]
    counts = pre.tiles_touched.contiguous()
    offsets = torch.cumsum(counts, 0) - counts
    rank = torch.empty(n, dtype=torch.int64, device=dev)
    rank[torch.argsort(pre.depth, stable=True)] = torch.arange(n, device=dev)
    rect_w = torch.clamp_min(pre.rect_max[:, 0] - pre.rect_min[:, 0], 1).int().contiguous()
    total = counts.sum().long()
    max_dup = int(total) // 2 if overflow else int(total) + 5000
    keys, gid = expand_kernel.expand_entries(counts, offsets, pre.rect_min.contiguous(), rect_w,
                                             rank, gx, max_dup)
    perm = torch.sort(keys, stable=True)[1]
    before = segment_sum_kernel.permute_launches
    got = segment_sum_kernel.permute_entries(gid, perm, total)
    torch.cuda.synchronize()
    assert segment_sum_kernel.permute_launches == before + 1
    for a, b in zip(got, binning.permute_entries_plain(gid, perm)):
        assert torch.equal(a, b)


def _segment_layout(dev, n, max_dup, seed):
    """A layout like the binning's: 90% of the n segments empty, the others of
    1-40 entries, segment n // 2 of 10^5; bounds clamped to the budget
    `max_dup`; order a random permutation of the budget's slots, ascending
    within each segment (a Gaussian's entries sit in ascending sorted order)."""
    rng = np.random.RandomState(seed)
    counts = np.where(rng.rand(n) < 0.9, 0, rng.randint(1, 41, n))
    counts[n // 2] = 100_000
    bounds = np.minimum(np.concatenate([[0], np.cumsum(counts)]), max_dup)
    order = rng.permutation(max_dup).astype(np.int32)
    seg = np.repeat(np.arange(n), np.diff(bounds))
    order[: seg.shape[0]] = order[: seg.shape[0]][np.lexsort((order[: seg.shape[0]], seg))]
    return counts, torch.as_tensor(bounds, device=dev), torch.as_tensor(order, device=dev)


@pytest.mark.parametrize("features", [9, 19])
@pytest.mark.parametrize("overflow", [False, True])
def test_segment_sum_routes_on_skewed_layouts(dev, features, overflow):
    """Kernel D on both routes (a layout, as the gather passes the binning's,
    and ids through segment_sum_rows) against segment_sum_rows_plain: mostly
    empty segments, one hot segment of 10^5 entries, and a budget that cuts
    the hot segment in the middle. Bitwise repeatable, the routes bitwise
    equal, empty segments exactly zero, one launch per call."""
    n = 40_000
    total = int(_segment_layout(dev, n, 1, 7)[0].sum())
    max_dup = total // 2 if overflow else total + 4096
    counts, bounds, order = _segment_layout(dev, n, max_dup, 7)
    rows = torch.randn((max_dup, features), generator=torch.Generator(device=dev).manual_seed(1),
                       device=dev)
    ids = segment_sum.layout_ids(bounds, order, max_dup)
    if overflow:
        assert 0 < int(bounds[n // 2 + 1] - bounds[n // 2]) < 100_000
    before = segment_sum_kernel.launches
    got = segment_sum_kernel.segment_sum_ordered(rows, bounds, order)
    got2 = segment_sum_kernel.segment_sum_ordered(rows, bounds, order)
    general = segment_sum_kernel.segment_sum_rows(rows, ids, n)
    torch.cuda.synchronize()
    assert segment_sum_kernel.launches == before + 3
    assert torch.equal(got, got2) and torch.equal(got, general)
    want = segment_sum.segment_sum_rows_plain(rows, ids, n)
    assert _rel(got, want) < 1e-5
    empty = torch.as_tensor(counts == 0, device=dev) | (bounds[1:] == bounds[:-1])
    assert not bool(got[empty].any()) and bool(got[~empty].any(1).all())


def test_train_step_on_card_matches_cpu(dev):
    """One training step on the card (every kernel launched) against the same
    step on the CPU: loss, per-leaf gradients and densification statistics."""
    p, s = synthetic.synthetic_scene(n=2000, n_sky=200, seed=3)
    cfg = Config()
    gen = torch.Generator().manual_seed(0)
    mlp = MLPNet(generator=gen)
    state = TS.init_train_state(p, s, mlp, torch.randn(2, 32, generator=gen))
    cam = synthetic.camera(64, 64)
    draws = TS.make_draws(gen, mlp, cfg)
    gt = torch.rand((64, 64, 3), generator=gen)
    ones = torch.ones(64, 64)
    rcfg = rasterize.RasterizerConfig(width=64, height=64, max_dup=1 << 15)
    args = (cam, gt, ones, ones, 0, draws, torch.zeros(3), mlp, cfg, rcfg)
    to = lambda tree: TS.tree_map(lambda x: x.to(dev), tree)
    card_args = (to(cam), gt.to(dev), ones.to(dev), ones.to(dev), 0, to(draws),
                 torch.zeros(3, device=dev), mlp, cfg, rcfg)
    for k in (expand_kernel, composite_kernel, segment_sum_kernel):
        k.launches = 0
    composite_kernel.backward_launches = 0
    on_card = TS.loss_and_grads(to(state), *card_args, device=dev)
    torch.cuda.synchronize()
    assert min(expand_kernel.launches, composite_kernel.launches,
               composite_kernel.backward_launches, segment_sum_kernel.launches) >= 1
    on_cpu = TS.loss_and_grads(state, *args, device="cpu")
    assert abs(float(on_card[0]) - float(on_cpu[0])) <= 1e-4 * abs(float(on_cpu[0]))
    for got, want in zip(TS.tree_leaves(on_card[2]) + [on_card[3]],
                         TS.tree_leaves(on_cpu[2]) + [on_cpu[3]]):
        if want.abs().max() > 0:
            assert _rel(got.cpu(), want) < 5e-3
    new, aux = TS.train_step(state, *args, device=dev)
    assert int(aux.overflow) == 0 and torch.isfinite(aux.loss)
    assert float(new.gauss_state.xyz_grad_accum.max()) > 0


def test_expand_intervals_kernel_matches_plain(dev):
    """Kernel A-int against the plain interval walk, bitwise: on a frame with
    one axis stretched 8x (rows taller than 8 tiles among them), with and
    without a budget overflow, and on hand-made rows (empty rows between
    nonempty ones, a tall Gaussian, a culled row)."""
    p, s = synthetic.synthetic_scene(n=20_000, n_sky=2_000, device=dev)
    cam = synthetic.camera(256, 256, device=dev)
    opa = G.get_opacity(p, s)[:, 0]
    scl = G.get_scaling(p) * torch.tensor([1.0, 8.0, 1.0], device=dev)
    pre = preprocess.preprocess(G.get_xyz(p, s), scl, G.get_rotation(p), cam.viewmat,
                                cam.projmat, cam.tan_fovx, cam.tan_fovy, 256, 256, 16,
                                active=s.alive, opacities=opa)
    counts, packed = preprocess.row_intervals(pre, opa)
    assert bool(((pre.rect_max[:, 1] - pre.rect_min[:, 1] > 8) & (counts > 0)).any())
    n = pre.depth.shape[0]
    offsets = torch.cumsum(counts, 0, dtype=torch.int64) - counts
    rank = torch.empty(n, dtype=torch.int64, device=dev)
    rank[torch.argsort(pre.depth, stable=True)] = torch.arange(n, device=dev)
    rect_w = torch.clamp_min(pre.rect_max[:, 0] - pre.rect_min[:, 0], 1).int().contiguous()
    total = int(counts.sum())
    cases = [(counts, offsets, pre.rect_min.contiguous(), rect_w, rank, 16, max_dup,
              packed.to(torch.int32).contiguous()) for max_dup in (total + 1000, total // 2)]
    packed_h = torch.zeros((8, 4), dtype=torch.int32)
    packed_h[0, 0], packed_h[2, 0], packed_h[5, 0] = 1 + 128 * 2, 128 * 3, 3 + 128
    packed_h[:, 1] = 128 * 4
    packed_h[1, 2], packed_h[4, 2] = 2 + 128, 128 * 3
    packed_h[0, 3] = 128 * 2
    counts_h = torch.tensor([6, 44, 4, 0], dtype=torch.int32)
    cases.append(tuple(x.to(dev) if isinstance(x, torch.Tensor) else x for x in (
        counts_h, torch.cumsum(counts_h, 0) - counts_h,
        torch.tensor([[2, 1], [0, 0], [5, 3], [1, 2]], dtype=torch.int32),
        torch.tensor([6, 4, 3, 2], dtype=torch.int32), torch.tensor([3, 0, 2, 1]), 20, 40,
        packed_h)))
    for *args, packed_i in cases:
        before = expand_kernel.interval_launches
        keys, gid = expand_kernel.expand_entries(*args, packed=packed_i)
        torch.cuda.synchronize()
        assert expand_kernel.interval_launches == before + 1
        p_keys, p_gid = binning.expand_entries_plain(*args, packed=packed_i)
        assert torch.equal(keys, p_keys) and torch.equal(gid, p_gid)


def test_interval_render_matches_rect_render(dev):
    """A small anisotropic scene on the card: the render and the gradients of
    its five inputs with row intervals on equal the rect render's (the JAX
    test's gates), with fewer entries and a launch of kernel A-int."""
    p, s = synthetic.synthetic_scene(n=20_000, n_sky=2_000, device=dev)
    cam = synthetic.camera(256, 256, device=dev)
    xyz, quat = G.get_xyz(p, s), G.get_rotation(p)
    scl = G.get_scaling(p) * torch.tensor([6.0, 1.0, 1.0], device=dev)
    opa = G.get_opacity(p, s)[:, 0]
    colors = torch.rand((xyz.shape[0], 3), generator=torch.Generator(device=dev).manual_seed(0),
                        device=dev)
    w = torch.randn((256, 256, 3), generator=torch.Generator(device=dev).manual_seed(1),
                    device=dev)
    out = {}
    for flag in (False, True):
        rcfg = rasterize.RasterizerConfig(width=256, height=256, max_dup=1 << 21,
                                          row_intervals=flag)
        leaves = [t.detach().clone().requires_grad_(True) for t in (xyz, scl, quat, opa, colors)]
        before = expand_kernel.interval_launches
        img, aux = rasterize.rasterize(*leaves, torch.zeros(3, device=dev), cam, rcfg,
                                       active=s.alive, device=dev)
        assert expand_kernel.interval_launches == before + int(flag)
        (torch.sum(img * w) + torch.sum(aux.alpha)).backward()
        out[flag] = (img.detach(), aux.alpha.detach(), [t.grad for t in leaves],
                     int(aux.num_entries), int(aux.overflow))
    assert out[True][3] < out[False][3] and out[True][4] == out[False][4] == 0
    assert float((out[True][0] - out[False][0]).abs().max()) <= 2e-6
    assert float((out[True][1] - out[False][1]).abs().max()) <= 2e-6
    for g0, g1 in zip(out[False][2], out[True][2]):
        assert float((g1 - g0).abs().max()) <= 5e-4 * float(g0.abs().max())
    # The entries intervals drop are skipped by every pixel, so on the card the
    # render and the gradients are the same bits.
    assert torch.equal(out[True][0], out[False][0]) and torch.equal(out[True][1], out[False][1])
    assert all(torch.equal(g0, g1) for g0, g1 in zip(out[False][2], out[True][2]))


# ------------------------------------------------------------------ pretraining


def test_embedding_net_on_card_matches_cpu(dev):
    """The full-width autoencoder (256x256, channels_f 128, latent 32, batch
    4): one training-mode forward and backward of the pretraining loss,
    float32 on the card and the CPU (TF32 off), float64 on the card as the
    exact reference (chip_smoke's `embedding_net_check`).
    The forward and the running statistics match; each of the card's
    gradients is within 5e-3 of the float64 one, or no farther from it than
    twice the CPU's float32 gradient (sums that mostly cancel at random
    weights put the CPU's own 2-6% off). The convolution biases in front of
    the batch norms have zero gradients up to rounding."""
    import copy

    from relightable3dgaussians_w_torch.models.nets import EmbeddingNet, fp32_convs

    gen = torch.Generator().manual_seed(0)
    cpu_net = EmbeddingNet(generator=gen)
    x = torch.rand((4, 256, 256, 3), generator=gen)
    outs = []
    for d, dt in (("cpu", torch.float32), (dev, torch.float32), (dev, torch.float64)):
        net, xx = copy.deepcopy(cpu_net).to(d, dt), x.to(d, dt)
        with fp32_convs():
            recon = net(xx, pretraining=True, train=True)
            torch.mean((recon - xx) ** 2).backward()
        outs.append((recon.detach().double().cpu(),
                     {k: p.grad.double().cpu() for k, p in net.named_parameters()},
                     {k: b.double().cpu() for k, b in net.named_buffers()}))
    (ref, cpu_g, ref_b), (got, card_g, got_b), (_, exact, _) = outs
    rel = lambda a, b: float((a - b).abs().max() / b.abs().max())
    assert rel(got, ref) < 1e-4
    top = max(float(g.abs().max()) for g in exact.values())
    for k, g in exact.items():
        if k.startswith(("conv.", "deconv.")) and k.endswith(".bias"):
            assert max(float(card_g[k].abs().max()), float(cpu_g[k].abs().max())) < 1e-4 * top, k
        else:
            assert rel(card_g[k], g) <= max(5e-3, 2 * rel(cpu_g[k], g)), k
    for k, b in ref_b.items():
        assert torch.allclose(got_b[k], b, rtol=1e-4, atol=1e-5), k


def test_pretraining_on_card(dev):
    """`pretrain_embedding_net` with a CUDA generator, `encode_embeddings` and
    `initialize_sh_mlp` run on the card: the loss falls, the codes are unit
    vectors, the MLP moves towards its priors."""
    from torch.func import functional_call

    from relightable3dgaussians_w_torch import pretrain

    imgs = np.random.RandomState(0).uniform(0, 1, (12, 64, 64, 3)).astype(np.float32)
    gen = torch.Generator(device=dev).manual_seed(1)
    net, losses = pretrain.pretrain_embedding_net(gen, imgs, num_epochs=4, batch_size=8,
                                                  log_every=100)
    assert np.mean(losses[-1]) < np.mean(losses[0])
    emb = pretrain.encode_embeddings(net, imgs)
    assert emb.device.type == "cuda" and emb.shape == (12, 32)
    assert float((torch.linalg.vector_norm(emb, dim=-1) - 1).abs().max()) < 1e-5
    mlp = MLPNet().to(dev)
    start = {k: v.detach().clone() for k, v in mlp.named_parameters()}
    names = [f"C0{i % 2}_IMG_{i:04d}" for i in range(12)]
    priors = {"C00.npy": np.full((25, 3), 0.5), "C01.npy": np.full((25, 3), -0.5)}
    fitted = pretrain.initialize_sh_mlp(gen, mlp, start, emb, names, priors, epochs=20)
    t = torch.as_tensor(pretrain.sh_prior_targets(names, priors, 25), device=dev)
    mse = lambda p: float(torch.mean((functional_call(mlp, p, (emb,))[0] - t) ** 2))
    assert mse(fitted) < mse(start)


# ------------------------------------------------------------------ library


@pytest.mark.parametrize("masked", [False, True])
def test_knn_dist2_morton_on_card_matches_cpu(dev, masked):
    from relightable3dgaussians_w_torch.ops import knn

    rng = np.random.RandomState(2)
    pts = torch.as_tensor(rng.normal(size=(50_000, 3)).astype(np.float32))
    mask = torch.as_tensor(rng.uniform(size=50_000) > 0.3) if masked else None
    got = knn.knn_dist2_morton(pts.to(dev), mask=None if mask is None else mask.to(dev))
    want = knn.knn_dist2_morton(pts, mask=mask)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.cpu(), want, rtol=1e-6, atol=0)


def test_bsdf_and_cubemap_on_card_match_cpu(dev, tmp_path):
    from relightable3dgaussians_w_torch.models import light_cubemap as cube
    from relightable3dgaussians_w_torch.ops import bsdf
    from relightable3dgaussians_w_torch.utils.hdr import write_hdr

    rng = np.random.RandomState(3)
    n = 100_000
    nrm = rng.normal(size=(n, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    # Roughness in [0.5, 1]: below it the GGX peak turns CUDA's rsqrtf (not
    # correctly rounded) into up to ~6e-4 of the largest value (ops/bsdf.py).
    arm = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    arm[:, 1] = 0.5 + 0.5 * arm[:, 1]
    cpu_in = [torch.as_tensor(a) for a in (
        rng.uniform(0, 1, (n, 3)).astype(np.float32), arm,
        rng.normal(size=(n, 3)).astype(np.float32), nrm, np.array([0.3, 2.0, 4.0], np.float32),
        np.array([-2.0, 3.0, 1.0], np.float32))]
    rel = lambda a, b: float((a.cpu() - b).abs().max() / b.abs().max())
    for mode in (0, 1):
        assert rel(bsdf.pbr_bsdf(*[a.to(dev) for a in cpu_in], bsdf=mode),
                   bsdf.pbr_bsdf(*cpu_in, bsdf=mode)) < 1e-5
    path = str(tmp_path / "env.hdr")
    yy, xx = np.mgrid[:64, :128] / 64   # smooth near the poles (chip_smoke.smooth_sky)
    sky = (0.2 + 0.6 * yy)[..., None] + 20.0 * np.exp(
        -((yy - 0.3) ** 2 + (xx - 0.7) ** 2) / (2 * 0.05 ** 2))[..., None]
    write_hdr(path, np.repeat(sky, 3, axis=-1).astype(np.float32))
    mips = {}
    for key, d in (("card", dev), ("cpu", "cpu")):
        base = cube.load_hdr_cubemap(path, 32, device=d)
        mips[key] = cube.build_mips(base)
    for a, b in zip(mips["card"].specular + (mips["card"].diffuse,),
                    mips["cpu"].specular + (mips["cpu"].diffuse,)):
        assert a.device.type == "cuda" and rel(a, b) < 1e-5
    lut = torch.as_tensor(rng.uniform(0, 1, (16, 16, 2)).astype(np.float32))
    ks = torch.as_tensor(rng.uniform(0, 1, (n, 3)).astype(np.float32))
    got = cube.shade_cubemap(mips["card"], cpu_in[2].to(dev), cpu_in[3].to(dev),
                             cpu_in[0].to(dev), ks.to(dev), cpu_in[4].to(dev), fg_lut=lut)
    want = cube.shade_cubemap(mips["cpu"], cpu_in[2], cpu_in[3], cpu_in[0], ks, cpu_in[4],
                              fg_lut=lut)
    assert rel(got, want) < 1e-5


# ------------------------------------------------------------------ parallel

_RANK_SCRIPT = r"""
import datetime, sys
import torch, torch.distributed as dist
from relightable3dgaussians_w_torch import synthetic
from relightable3dgaussians_w_torch.models import gaussians as G
from relightable3dgaussians_w_torch.ops import rasterize
from relightable3dgaussians_w_torch.parallel import gauss_shard as GS

backend, rdv, rank, world = sys.argv[1], sys.argv[2], int(sys.argv[3]), int(sys.argv[4])
dev = torch.device("cuda", 0)
torch.cuda.set_device(dev)
dist.init_process_group(backend, init_method=f"file://{rdv}", rank=rank, world_size=world,
                        timeout=datetime.timedelta(seconds=120))
p, s = synthetic.synthetic_scene(n=20_000, n_sky=2_000, device=dev)
cam = synthetic.camera(256, 256, device=dev)
cfg = rasterize.RasterizerConfig(width=256, height=256, max_dup=1 << 19)
full = [G.get_xyz(p, s), G.get_scaling(p), G.get_rotation(p), G.get_opacity(p, s)[:, 0],
        torch.rand((22_000, 3), generator=torch.Generator(device=dev).manual_seed(0), device=dev)]
full = [x.detach().requires_grad_(True) for x in full]
bg = torch.zeros(3, device=dev)
w = torch.randn((256, 256, 3), generator=torch.Generator(device=dev).manual_seed(1), device=dev)
ref, ref_aux = rasterize.rasterize(*full, bg, cam, cfg, active=s.alive, device=dev)
(ref * w).sum().backward()
n = 22_000 // world
sl = slice(rank * n, (rank + 1) * n)
loc = [x.detach()[sl].clone().requires_grad_(True) for x in full]
img, aux = GS.rasterize_gauss_sharded(*loc, bg, cam, cfg, dist.group.WORLD, active=s.alive[sl])
((img * w).sum() / world).backward()
assert torch.equal(img, ref) and torch.equal(aux.alpha, ref_aux.alpha), "image differs"
assert int(aux.overflow) == 0 and torch.equal(aux.radii, ref_aux.radii)
for a, b in zip(loc, full):   # (isotropic scales: the quaternions' gradient is zero)
    err = float((a.grad - b.grad[sl]).abs().max() / max(float(b.grad.abs().max()), 1e-30))
    assert err < 5e-3, err
dist.destroy_process_group()
print("rank ok", dist.is_available(), backend, flush=True)
"""


def _run_ranks(backend, world, tmp_path):
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo)
    procs = [subprocess.Popen([sys.executable, "-c", _RANK_SCRIPT, backend,
                               str(tmp_path / "rdv"), str(r), str(world)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    outs = []
    try:
        outs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, o in zip(procs, outs):
        assert p.returncode == 0 and "rank ok" in o, o[-3000:]


def test_tile_parallel_on_card_bitwise(dev):
    """Two bands of tile rows on the card: image, alpha and radii bitwise the
    single-device render's."""
    from relightable3dgaussians_w_torch.parallel import tile_parallel as TP

    p, s = synthetic.synthetic_scene(n=20_000, n_sky=2_000, device=dev)
    cam = synthetic.camera(256, 256, device=dev)
    cfg = rasterize.RasterizerConfig(width=256, height=256, max_dup=1 << 19)
    args = (G.get_xyz(p, s), G.get_scaling(p), G.get_rotation(p), G.get_opacity(p, s)[:, 0],
            torch.rand((22_000, 13), generator=torch.Generator(device=dev).manual_seed(0),
                       device=dev), torch.zeros(13, device=dev))
    ref, ref_aux = rasterize.rasterize(*args, cam, cfg, active=s.alive, device=dev)
    img, aux = TP.rasterize_tile_sharded(*args, cam, cfg, [dev, dev], active=s.alive)
    assert torch.equal(img, ref) and torch.equal(aux.alpha, ref_aux.alpha)
    assert torch.equal(aux.radii, ref_aux.radii) and int(aux.overflow) == 0


def test_gauss_sharded_nccl_one_rank(dev, tmp_path):
    """A 1-rank NCCL group (a subprocess): the gauss-sharded render with D = 1
    bitwise the single-device render's, its gradients within 5e-3."""
    _run_ranks("nccl", 1, tmp_path)


def test_gauss_sharded_gloo_two_ranks_on_card(dev, tmp_path):
    """Two gloo ranks sharing the card: the gauss-sharded render with D = 2
    bitwise the single-device render's, its gradients within 5e-3."""
    _run_ranks("gloo", 2, tmp_path)


def test_selfcheck_learns_on_card(dev):
    """The training self-check's first 300 iterations at its defaults (128x128,
    8 views) on the card: the best checkpoint at least 6 dB above the first
    (the JAX package's CPU run climbs 11.8 dB by iteration 300,
    SELFCHECK_r02_cpu.jsonl), with no entry overflow."""
    setup = SC.build_selfcheck(128, 8, dev, torch.Generator(device=dev).manual_seed(0))
    run = SC.run_selfcheck(setup, 300, log=lambda *_: None)
    psnrs = [p for _, p in run.trajectory]
    assert [it for it, _ in run.trajectory] == [1, 100, 200, 300]
    assert max(psnrs) - psnrs[0] >= 6.0, run.trajectory
    assert run.overflow == 0 and all(np.isfinite(psnrs))


def test_device_ms_queued_matches_profiler(dev):
    """`utils.timing.queued_ms` (each call queued behind a spinning kernel,
    timed with CUDA events) reads within 10% of what a fresh process's
    profiler reads for a gather of 2M rows, and a call that waits for the
    card cannot be queued ahead."""
    from relightable3dgaussians_w_torch.utils import timing

    rows = torch.randn(1 << 20, 9, device=dev)
    idx = torch.randint(0, 1 << 20, (1 << 21,), device=dev)
    gather = lambda: rows[idx]
    queued = timing.queued_ms(gather, 10)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(10):
            gather()
        torch.cuda.synchronize()
    profiled = sum(e.self_device_time_total for e in timing.device_events(prof)) / 1e4
    assert queued is not None and profiled > 0
    assert abs(queued - profiled) < 0.1 * profiled, (queued, profiled)
    assert timing.queued_ms(lambda: float(rows[idx].sum()), 3) is None
