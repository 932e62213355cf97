"""Wrappers of the port's hand-written CUDA kernels (sources in `csrc/`).

Each wrapper launches its kernel for a CUDA tensor and counts the launch in its
module's `launches`; for a CPU tensor it calls the kernel's plain PyTorch
version, which lives beside the code it replaces (`ops/preprocess.py`,
`ops/binning.py`, `ops/composite.py`, `ops/shading.py`). A build or launch failure raises:
there is no fallback.

`KERNEL_COUNTERS` names each kernel's counter; `launch_counts()` reads them all
and `reset_launches()` sets them all to 0.
"""

from . import (expand, preprocess, row_intervals, segment_sum, shade, tile_composite,
               view_unpack)

# Each CUDA kernel's launch counter: kernel -> (wrapper module, counter name).
KERNEL_COUNTERS = {"row_intervals": (row_intervals, "launches"),
                   "expand_entries": (expand, "launches"),
                   "expand_entries_intervals": (expand, "interval_launches"),
                   "composite_forward": (tile_composite, "launches"),
                   "composite_forward_packed": (tile_composite, "packed_launches"),
                   "composite_backward": (tile_composite, "backward_launches"),
                   "segment_sum_rows": (segment_sum, "launches"),
                   "permute_entries": (segment_sum, "permute_launches"),
                   "shade_forward": (shade, "launches"),
                   "shade_backward": (shade, "backward_launches"),
                   "view_unpack": (view_unpack, "launches"),
                   "preprocess_forward": (preprocess, "launches"),
                   "preprocess_backward": (preprocess, "backward_launches")}


def launch_counts() -> dict:
    """Each kernel's launches in this process since the last reset."""
    return {k: getattr(mod, attr) for k, (mod, attr) in KERNEL_COUNTERS.items()}


def reset_launches():
    for mod, attr in KERNEL_COUNTERS.values():
        setattr(mod, attr, 0)
