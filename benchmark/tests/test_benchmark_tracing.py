"""The readers of the port's host and device ranges, each on a `TraceContext`
built by hand from known kernels, device spans and host events (times in
microseconds, as the profiler gives them), with answers worked out by hand;
and each finds nothing to read where its range did not run."""

from __future__ import annotations

from collections import defaultdict

import pytest

from benchmark import common
from benchmark.trace import TraceContext

READERS = ("mlp_device_ms.serve", "shading_device_ms.serve", "sort_device_ms.serve",
           "send_ms.serve", "wait_ms.serve", "shading_device_ms.train",
           "backward_device_ms.train", "overflow_wait_ms.train")


def context(steps, kernels, spans=(), cpu=()):
    ctx = TraceContext.__new__(TraceContext)
    ctx.steps, ctx.info, ctx._memo, ctx.windows = steps, {}, {}, None
    ctx.launches, ctx.captures = {}, defaultdict(list)
    ctx.kernels = sorted(kernels, key=lambda k: k[1])
    ctx.spans = defaultdict(list)
    for name, s, e in spans:
        ctx.spans[name].append((s, e))
    ctx.cpu = list(cpu)
    ctx.window_s = 1.0
    return ctx


def read(name, ctx):
    return common.metric_reader(name).read(ctx)


def serve_context():
    """Two frames, at 0 and 100 ms."""
    kernels = [("gemm", 1_000, 1_500), ("relu", 1_600, 2_000),          # MLP, frame 1
               ("cat", 3_000, 7_000), ("mul", 7_500, 10_000),           # shading
               ("argsort", 12_000, 12_500), ("expand_kernel", 12_600, 13_000),
               ("radix_sort", 13_000, 15_000),                          # the sort
               ("composite_fwd_kernel", 20_000, 30_000),                # outside every span
               ("gemm", 101_000, 101_300),                              # frame 2
               ("cat", 103_000, 108_000), ("radix_sort", 112_000, 114_000),
               ("composite_fwd_kernel", 120_000, 130_000)]
    spans = [("nets.mlp", 1_000, 2_000), ("renderer.shading", 3_000, 10_000),
             ("binning.sort", 12_000, 15_000), ("rasterize.binning", 11_000, 16_000),
             ("nets.mlp", 101_000, 102_000), ("renderer.shading", 103_000, 108_000),
             ("binning.sort", 112_000, 114_000), ("rasterize.binning", 111_000, 115_000)]
    cpu = [("viewer.request", 0, 900), ("viewer.send", 40_000, 50_000),
           ("viewer.wait", 50_500, 55_500), ("viewer.request", 100_000, 100_900),
           ("viewer.send", 140_000, 152_000), ("viewer.wait", 152_500, 157_600),
           ("aten::cat", 3_000, 3_100)]
    return context(2, kernels, spans, cpu)


def train_context():
    """Two steps: leaf inputs (shading), losses, backward, Adam, with kernels
    before the losses and after Adam that the backward must not take."""
    kernels = [("shade", 1_000, 8_000), ("loss", 10_000, 20_000),
               ("bwd_a", 20_000, 30_000), ("bwd_b", 28_000, 35_000),     # overlap: 15 ms
               ("composite_bwd_kernel", 40_000, 50_000),                # 10 ms
               ("zeros", 55_000, 62_000),                               # 5 ms before Adam
               ("adam", 60_000, 70_000), ("next_leaf", 70_000, 90_000),  # after Adam
               ("shade", 101_000, 105_000), ("loss", 110_000, 120_000),
               ("segment_sum_kernel", 120_000, 140_000),                # 20 ms
               ("adam", 150_000, 160_000), ("after", 160_000, 200_000)]
    spans = [("renderer.shading", 1_000, 8_000), ("train_step.leaf_inputs", 500, 9_000),
             ("train_step.losses", 10_000, 20_000), ("train_step.adam", 60_000, 70_000),
             ("renderer.shading", 101_000, 105_000), ("train_step.leaf_inputs", 100_500, 106_000),
             ("train_step.losses", 110_000, 120_000), ("train_step.adam", 150_000, 160_000)]
    cpu = [("trainer.iteration", 94_000, 210_000), ("trainer.overflow_read", 95_000, 99_000),
           ("trainer.iteration", 204_000, 260_000), ("trainer.overflow_read", 205_000, 211_000),
           ("train_step.backward", 20_000, 56_000)]
    return context(2, kernels, spans, cpu)


@pytest.mark.parametrize("name, want", [
    ("mlp_device_ms.serve", (0.9 + 0.3) / 2),
    ("shading_device_ms.serve", (6.5 + 5.0) / 2),
    ("sort_device_ms.serve", (2.9 + 2.0) / 2),
    ("send_ms.serve", 11.0),                   # median of 10 and 12
    ("wait_ms.serve", (5.0 + 5.1) / 2),
])
def test_serve_readers_by_hand(name, want):
    assert read(name, serve_context()) == pytest.approx(want)


@pytest.mark.parametrize("name, want", [
    ("shading_device_ms.train", (7.0 + 4.0) / 2),
    # step 1: 15 + 10 + 5 (the kernel that runs into Adam, cut at its start);
    # step 2: 20
    ("backward_device_ms.train", (30.0 + 20.0) / 2),
    ("overflow_wait_ms.train", (4.0 + 6.0) / 2),
])
def test_train_readers_by_hand(name, want):
    assert read(name, train_context()) == pytest.approx(want)


def test_backward_takes_nothing_from_before_the_losses_or_after_adam():
    ctx = train_context()
    want = read("backward_device_ms.train", ctx)
    # work added before each step's losses and after each Adam changes nothing
    ctx.kernels = sorted(ctx.kernels + [("early", 9_000, 10_000), ("late", 70_000, 100_000),
                                        ("tail", 200_000, 300_000)], key=lambda k: k[1])
    assert read("backward_device_ms.train", ctx) == pytest.approx(want)
    # work added between them counts
    ctx.kernels = sorted(ctx.kernels + [("mid", 36_000, 38_000)], key=lambda k: k[1])
    assert read("backward_device_ms.train", ctx) == pytest.approx(want + 1.0)


@pytest.mark.parametrize("name", READERS)
def test_readers_find_nothing_where_their_range_did_not_run(name):
    # a profile of a program without the ranges: kernels and the rasterizer's
    # and the step's other ranges only
    ctx = context(2, [("gemm", 0, 10), ("adam", 20, 30)],
                  [("rasterize.binning", 0, 10), ("train_step.adam", 20, 30)],
                  [("benchmark.serve_frame", 0, 40), ("aten::mm", 0, 5)])
    assert read(name, ctx) is None
