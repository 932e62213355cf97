"""The `train_collection` kind and the collection configuration's cell: a
tiny collection cell runs and is correct on the CPU, a step fed another
photo's canvas is not, the view store's readers read a synthetic slice, and
the cell's layout holds what PERF.md says of it."""

from __future__ import annotations

import copy
import time
from collections import defaultdict

import pytest
import torch

from benchmark import common, view_bounds
from benchmark.drivers import train_collection
from benchmark.trace import TraceContext

NEW_CELLS = ("train-trevi-1600",)
TRAIN_READERS = ("mfu.train", "device_idle_pct.train", "composite_bwd_roofline",
                 "segment_sum_roofline", "adam_device_ms.train", "leaf_inputs_device_ms.train",
                 "shading_device_ms.train", "backward_device_ms.train",
                 "shading_bwd_device_ms.train", "overflow_wait_ms.train")
STORE_READERS = ("view_fetch_device_ms.train", "view_unpack_roofline",
                 "padded_pixel_share.train")


def tiny_collection() -> dict:
    """train-trevi-1600 cut to five photos in three sizes and 3,000 points in
    a small box (few sky Gaussians)."""
    c = copy.deepcopy(common.load_cell("train-trevi-1600"))
    sc = c["config_data"]["scene"]
    sc.update(n_foreground=3000, box=[[-0.6, 0.6], [-0.6, 0.6], [3.0, 4.5]],
              photo_mix=[{"photos": 2, "size": [48, 36]}, {"photos": 2, "size": [48, 32]},
                         {"photos": 1, "size": [36, 48]}])
    c["config_data"]["runtime"].update(pool_headroom=2.0, max_dup=0)
    c["traffic_data"].update(start_sample=64)
    return c


def test_tiny_collection_cell_is_correct():
    res, checks = train_collection.run(tiny_collection(), 2 ** 31 + 17, 0.5, False,
                                       time.perf_counter(), device="cpu")
    assert res["correct"], checks
    assert checks["view_bytes_differ"]["value"] == 0 and res["attempted"] > 0
    store = res["details"]["view_store"]
    assert store["photos"] == 5 and store["device_bytes"] == 5 * store["pixels"]


def test_wrong_photos_canvas_is_not_correct():
    res, checks = train_collection.run(tiny_collection(), 99, 0.2, False, time.perf_counter(),
                                       device="cpu", faults=("wrong_photo",))
    assert not res["correct"] and checks["view_bytes_differ"]["value"] > 0, checks
    assert checks["loss_gap"]["value"] > checks["loss_gap"]["limit"], checks


def test_half_the_pixels_out_of_the_loss_is_not_correct():
    res, checks = train_collection.run(tiny_collection(), 99, 0.2, False, time.perf_counter(),
                                       device="cpu", faults=("half_batch",))
    assert not res["correct"] and checks["view_bytes_differ"]["value"] == 0, checks
    assert checks["loss_gap"]["value"] > checks["loss_gap"]["limit"], checks


def test_a_canvas_of_another_size_counts_every_element():
    """The reference's canvas is the largest photo's, worked out from the
    collection: a program's canvas of another size differs in every element."""
    want = [torch.zeros(4, 6, 3), torch.ones(4, 6)]
    same = [torch.zeros(4, 6, 3), torch.ones(4, 6)]
    same[1][2, 3] = 0.5
    assert train_collection.canvases_differ(same, want) == 1
    assert train_collection.canvases_differ([torch.zeros(3, 6, 3), torch.ones(4, 7)],
                                            want) == 72 + 28
    c = tiny_collection()
    views = train_collection.collection_views(c["traffic_data"], c["config_data"]["scene"], 5)
    assert (max(v["height"] for v in views), max(v["width"] for v in views)) == (48, 48)


def test_collection_layout_is_seeded_and_mixed():
    c = tiny_collection()
    a = train_collection.collection_views(c["traffic_data"], c["config_data"]["scene"], 5)
    b = train_collection.collection_views(c["traffic_data"], c["config_data"]["scene"], 5)
    assert [v["name"] for v in a] == sorted(v["name"] for v in a)
    assert [(v["width"], v["height"], v["focal"]) for v in a] == [
        (v["width"], v["height"], v["focal"]) for v in b]
    assert {(v["width"], v["height"]) for v in a} == {(48, 36), (48, 32), (36, 48)}
    for v in a:
        sky, occ = train_collection.sky_mask(v), train_collection.occluder_mask(v)
        top = (sky[:, :] == 0).sum(0) / v["height"]
        assert 0.2 < top.min() and top.max() < 0.45
        assert 0.0 < (occ == 0).mean() <= 0.12


def _ctx(info, launches, kernels, spans):
    ctx = TraceContext.__new__(TraceContext)
    ctx.steps, ctx.info, ctx._memo, ctx.windows = 3, info, {}, None
    ctx.launches, ctx.captures = launches, defaultdict(list)
    ctx.kernels = sorted(kernels, key=lambda k: k[1])
    ctx.spans = defaultdict(list)
    for n, s, e in spans:
        ctx.spans[n].append((s, e))
    ctx.cpu, ctx.window_s = [], 1.0
    return ctx


def test_store_readers_on_a_synthetic_slice():
    photo, canvas = 3 * 1_920_000, 3 * 2_560_000
    kernels = [("void (anonymous namespace)::view_unpack_kernel<3>(...)", 100 * i, 100 * i + 20)
               for i in range(3)] + [("gemm", 50, 90), ("gemm", 150, 160)]
    spans = [("trainer.view_fetch", 100 * i, 100 * i + 25) for i in range(3)]
    info = {"store_bytes_per_pixel": 5.0, "window_fetch_photo_pixels": 7_300_000,
            "window_fetch_canvas_pixels": 10_000_000}
    launches = {"view_unpack": 3, "view_store.fetches": 3,
                "view_store.fetch_photo_pixels": photo, "view_store.fetch_canvas_pixels": canvas}
    ctx = _ctx(info, launches, kernels, spans)
    read = lambda name: common.metric_reader(name).read(ctx)
    assert read("view_fetch_device_ms.train") == pytest.approx(0.02)       # 20 us a step
    bound = (photo * 5 + canvas * 20) / view_bounds.HBM_BYTES_PER_S
    assert read("view_unpack_roofline") == pytest.approx(100 * bound / 60e-6)
    assert read("padded_pixel_share.train") == pytest.approx(27.0)
    # a launch the profile missed raises; a program without the store reads nothing
    ctx.kernels = ctx.kernels[1:]
    with pytest.raises(RuntimeError):
        read("view_unpack_roofline")
    bare = _ctx({}, {"view_unpack": 0}, [("gemm", 0, 1)], [])
    assert all(common.metric_reader(n).read(bare) is None for n in STORE_READERS)


def test_new_cell_layout():
    bench = common.load_benchmark()
    listed = {m["name"]: m.get("workloads") for m in bench["end_to_end"] + bench["per_layer"]}
    for name in NEW_CELLS:
        cell = common.load_cell(name)
        assert cell["chips"] == 1
        assert {m["name"] for m in cell["end_to_end"]} == {"train_images_per_s", "setup_s"}
        for r in TRAIN_READERS:
            assert name in listed[r], (name, r)
        rt = dict(cell["config_data"]["runtime"], **cell["traffic_data"]["runtime"])
        assert rt["max_dup"] % 4096 == 0 and rt["max_dup"] > 1 << 23, name
        assert set(cell["limits"]) >= {"first_grad_gap", "change_gap", "start_exact_gap",
                                       "start_scale_gap", "start_sky_gap"}
    trevi = common.load_cell("train-trevi-1600")
    assert {m["name"] for m in trevi["per_layer"]} >= set(STORE_READERS)
    assert trevi["limits"]["view_bytes_differ"] == 0 and trevi["config_data"]["reduced"] == []
    assert 3.1e-5 < trevi["limits"]["loss_gap"] < 2.6e-3   # PERF.md: the readings around it
    mix = trevi["config_data"]["scene"]["photo_mix"]
    assert sum(m["photos"] for m in mix) == 1689
    pixels = sum(m["photos"] * m["size"][0] * m["size"][1] for m in mix)
    assert round(pixels / 1e9, 2) == 3.15
    assert round(100 * (1 - pixels / (1689 * 1600 * 1600)), 1) == 27.1


@pytest.mark.cuda
def test_tiny_collection_cell_is_correct_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernels have no CPU mode)")
    res, checks = train_collection.run(tiny_collection(), 41, 1.0, False, time.perf_counter(),
                                       device="cuda")
    assert res["correct"], checks
