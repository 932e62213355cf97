"""Torch's intra-op threads for the port's tests under pytest-xdist.

Each xdist worker gets its share of the cores (one thread each for 6 workers
on 8 cores): torch's default of one thread per core in every worker
oversubscribes the CPU and slows the torch-heavy tests several times over
(on an 8-core CPU the port's test files took 290 s of wall time on 6
workers with 8 threads each, 129 s with 1). A run without xdist keeps
torch's default.
"""

import os

import torch


def share_cores():
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "0"))
    if workers > 1:
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))
