"""A run with the timed path broken underneath, and the control, each come out
not correct: the harness's look for a card is skipped, the rest of a run is
driven at a tiny size on the CPU."""

from __future__ import annotations

import time

import pytest

from benchmark.drivers import serve, train
from benchmark.tests._cells import tiny_serve, tiny_train


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch", "control"])
def test_training_fault_is_not_correct(fault):
    res, checks = train.run(tiny_train(), 4242, 0.5, False, time.perf_counter(), device="cpu",
                            faults=(fault,))
    assert not res["correct"], checks
    if fault == "control":
        # the starting state's control fails the start's own numbers too
        for k in ("start_scale_gap", "start_sky_gap"):
            assert checks[k]["value"] > checks[k]["limit"], checks


@pytest.mark.parametrize("fault", ["frame_altered", "control"])
def test_serving_fault_is_not_correct(fault):
    res, checks = serve.run(tiny_serve(), 4343, 2.0, False, time.perf_counter(), device="cpu",
                            faults=(fault,))
    assert not res["correct"], checks


def test_overflowed_frames_are_not_correct():
    cell = tiny_serve()
    cell["traffic_data"]["budget_headroom"] = 0.5   # half the entries a frame needs
    res, checks = serve.run(cell, 4444, 1.0, False, time.perf_counter(), device="cpu")
    assert not res["correct"] and checks["frames_overflowed"]["value"] > 0, checks
