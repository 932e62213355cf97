"""On the card: the tiny cells through the kernels agree with the reference,
and a checkout that holds only the benchmark fails with no result. Run there
with `python3 -m pytest benchmark/tests -m cuda --noconftest -q`."""

from __future__ import annotations

import shutil
import subprocess
import sys
import time

import pytest
import torch

from benchmark import common
from benchmark.drivers import serve, train
from benchmark.tests._cells import tiny_serve, tiny_train


def need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernels have no CPU mode)")


@pytest.mark.cuda
def test_tiny_cells_are_correct_on_the_card():
    need_card()
    res, checks = train.run(tiny_train(), 31, 1.0, False, time.perf_counter(), device="cuda")
    assert res["correct"], checks
    res, checks = serve.run(tiny_serve(), 32, 2.0, False, time.perf_counter(), device="cuda")
    assert res["correct"], checks


@pytest.mark.cuda
def test_benchmark_alone_fails_with_no_result(tmp_path):
    need_card()
    shutil.copytree(common.BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(common.ROOT / "BENCHMARK.json", tmp_path)
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", "serve-3m-1600",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=tmp_path, timeout=600)
    assert out.returncode != 0 and out.stdout.strip() == ""
