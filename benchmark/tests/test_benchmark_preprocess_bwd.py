"""The reader of the preprocess backward's range, `preprocess_bwd_device_ms.train`,
on the hand-made training trace of `test_benchmark_tracing.py` with the range
added, worked out by hand; and nothing to read where the range did not run."""

from __future__ import annotations

from benchmark.tests.test_benchmark_tracing import context, read, train_context

import pytest


def test_preprocess_backward_reader_by_hand():
    ctx = train_context()
    # step 1: bwd_a 20-30 ms and bwd_b 28-35 ms, cut to the range's 25-35 ms:
    # 5 + 7; step 2: segment_sum_kernel 120-140 ms cut to 130-140 ms: 10
    ctx.spans["rasterize.preprocess_backward"] += [(25_000, 35_000), (130_000, 140_000)]
    assert read("preprocess_bwd_device_ms.train", ctx) == pytest.approx((12.0 + 10.0) / 2)


def test_preprocess_backward_reader_finds_nothing_without_its_range():
    assert read("preprocess_bwd_device_ms.train", train_context()) is None
    ctx = context(2, [("gemm", 0, 10)], [("train_step.adam", 0, 10)])
    assert read("preprocess_bwd_device_ms.train", ctx) is None
