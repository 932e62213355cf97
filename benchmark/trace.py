"""The traced slice of a `--trace 1` run and the reductions the per-layer
readers take from it.

A driver opens a `TraceSlice` over a few whole steps (or frames) inside the
measured window: a device sync, `torch.profiler` over CPU and CUDA activity,
the port's launch counters before and after, and the kernel calls the
readers need captured (their inputs kept for the bound arithmetic). After the
window the driver turns it into a `TraceContext`, which the readers in
`benchmark/metrics/` read.
"""

from __future__ import annotations

import time
from collections import defaultdict

import numpy as np
import torch

# Kernel name (a substring of the demangled CUDA name) of each launch counter
# of the port (`ops/cuda.KERNEL_COUNTERS`) that a reader relies on.
KERNEL_NAMES = {"composite_forward": "composite_fwd_kernel",
                "composite_forward_packed": "composite_fwd_kernel",
                "composite_backward": "composite_bwd_kernel",
                "segment_sum_rows": "segment_sum_kernel",
                "permute_entries": "permute_kernel"}


class TraceSlice:
    """Profile `steps` whole steps starting at the driver's step `first`:
    call `at(i)` before step i runs; the slice opens at `first` and closes at
    `first + steps`. `captures` collects what `capture` is handed while the
    slice is open."""

    def __init__(self, first: int, steps: int, launch_counts, capture_last: int = 1):
        self.first, self.steps = first, steps
        self.capture_last = capture_last
        self.current = -1
        self.steps_done = 0
        self.launch_counts = launch_counts
        self.prof = None
        self.open = False
        self.done = False
        self.captures = defaultdict(list)
        self.t0 = self.t1 = None
        self.counts0 = self.counts1 = None

    @staticmethod
    def warm():
        """Start the profiler once in set-up: its first start (CUPTI's) is
        slow, and would otherwise fall inside the window."""
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]):
            (torch.ones(1024, device="cuda") * 2).sum().item()

    def at(self, i: int):
        """Before step i."""
        self.current = i
        if self.open:
            self.steps_done += 1
        if i == self.first and not self.done:
            torch.cuda.synchronize()
            self.counts0 = self.launch_counts()
            self.prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA])
            self.prof.__enter__()
            torch.cuda.synchronize()
            self.t0 = time.perf_counter()
            self.open = True
        elif i == self.first + self.steps and self.open:
            self.close()

    def close(self):
        if not self.open:
            return
        torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self.counts1 = self.launch_counts()
        self.prof.__exit__(None, None, None)
        self.open, self.done = False, True

    def capture(self, kind: str, value):
        """Keep a kernel call's inputs, in the slice's last `capture_last`
        steps only: a kept tensor holds its memory, so a later step of the
        slice would allocate anew and the profile would show the allocator."""
        if self.open and self.current >= self.first + self.steps - self.capture_last:
            self.captures[kind].append(value)


class TraceContext:
    """What the readers read: device events of the slice, the port's ranges'
    device spans, launch counts, captured kernel inputs, and the driver's own
    numbers (`info`)."""

    def __init__(self, sl: TraceSlice, info: dict, step_range: str | None = None):
        """step_range: the name of a profiler range around each step; where
        given, the window is those ranges' time alone (a server's frames,
        not its waits for the next request) and so is the busy time."""
        if not sl.done or sl.steps_done != sl.steps:
            raise RuntimeError(f"the traced slice covered {sl.steps_done} of {sl.steps} steps: "
                               "the window ended first")
        self.steps = sl.steps
        self.window_s = sl.t1 - sl.t0
        self.launches = {k: sl.counts1[k] - sl.counts0[k] for k in sl.counts1}
        self.captures = sl.captures
        self.info = info
        self._memo = {}
        cuda = torch.autograd.DeviceType.CUDA
        self.kernels, self.spans, self.cpu = [], defaultdict(list), []
        for e in sl.prof.events():
            r = (e.time_range.start, e.time_range.end)
            if e.device_type == cuda:
                if getattr(e, "is_user_annotation", False):
                    self.spans[e.name].append(r)
                else:
                    self.kernels.append((e.name, r[0], r[1]))
            else:
                self.cpu.append((e.name, r[0], r[1]))
        self.kernels.sort(key=lambda k: k[1])
        if not self.kernels:
            raise RuntimeError("the profile caught no device activity")
        self.windows = None
        if step_range is not None:
            self.windows = sorted((s, e) for n, s, e in self.cpu if n == step_range)
            if len(self.windows) != sl.steps:
                raise RuntimeError(f"{len(self.windows)} {step_range} ranges in the profile, "
                                   f"{sl.steps} steps traced")
            self.window_s = sum(e - s for s, e in self.windows) / 1e6

    def memo(self, key, fn):
        """fn() computed once per context (readers share costly counts)."""
        if key not in self._memo:
            self._memo[key] = fn()
        return self._memo[key]

    def composite_pairs(self, kind: str) -> list[dict]:
        """`roofline.pair_counts` of each captured compositor call of `kind`."""
        from .roofline import pair_counts

        return self.memo(("pairs", kind), lambda: [
            pair_counts(feat, ts, te, self.info["grid_x"])
            for feat, ts, te in self.captures[kind]])

    # -- device time

    def busy_s(self) -> float:
        """Seconds in which some operation ran on the device (interval union),
        inside the step ranges where the window is made of them."""
        total, end = 0.0, -np.inf
        for _, s, e in self.kernels:
            if e <= end:
                continue
            total += self._inside(max(s, end), e)
            end = e
        return total / 1e6

    def _inside(self, s: float, e: float) -> float:
        if self.windows is None:
            return e - s
        return sum(max(0.0, min(e, we) - max(s, ws)) for ws, we in self.windows)

    def kernel_times_ms(self, substr: str) -> list[float]:
        """Device ms of each launch whose name holds `substr`, in launch order."""
        return [(e - s) / 1e3 for n, s, e in self.kernels if substr in n]

    def checked_kernel_times_ms(self, counter: str) -> list[float]:
        """`kernel_times_ms` of a launch counter's kernel; raises unless the
        profile caught exactly as many launches as the counter counted."""
        times = self.kernel_times_ms(KERNEL_NAMES[counter])
        if counter == "composite_forward" or counter == "composite_forward_packed":
            want = self.launches["composite_forward"] + self.launches["composite_forward_packed"]
        else:
            want = self.launches[counter]
        if len(times) != want or want == 0:
            raise RuntimeError(f"the profile caught {len(times)} launches of "
                               f"{KERNEL_NAMES[counter]}, the counter {want}")
        return times

    def range_device_ms(self, name: str) -> float | None:
        """Device ms per step of a profiler range: the kernel time inside its
        device spans (the card runs one stream, so a span's kernels are the
        range's), or None where the range did not run."""
        spans = self.spans.get(name)
        if not spans:
            return None
        starts = np.array([k[1] for k in self.kernels])
        ends = np.array([k[2] for k in self.kernels])
        busy = 0.0
        for s, e in spans:
            busy += float(np.clip(np.minimum(ends, e) - np.maximum(starts, s), 0, None).sum())
        return busy / 1e3 / self.steps

    # -- breakdown

    def top_device_ops(self, k: int = 10):
        by = defaultdict(float)
        for n, s, e in self.kernels:
            by[n[:80]] += (e - s) / 1e6
        return sorted(([n, v] for n, v in by.items()), key=lambda x: -x[1])[:k]

    def idle_gaps(self, k: int = 10, min_us: float = 20.0):
        """The device's idle gaps inside the window (the step ranges, where it
        is made of them), summed by the innermost host-side event (a profiler
        range or an operator) running at each gap's midpoint."""
        names = [c[0] for c in self.cpu]
        cs = np.array([c[1] for c in self.cpu]) if self.cpu else np.zeros(0)
        ce = np.array([c[2] for c in self.cpu]) if self.cpu else np.zeros(0)
        by = defaultdict(float)
        end = self.kernels[0][2]
        for _, s, e in self.kernels[1:]:
            gap = self._inside(end, s) if s > end else 0.0
            if gap >= min_us:
                mid = 0.5 * (s + end)
                inside = np.nonzero((cs <= mid) & (ce >= mid))[0]
                if len(inside):
                    j = inside[np.argmin(ce[inside] - cs[inside])]
                    by[names[j][:80]] += gap / 1e6
                else:
                    by["(no traced host event)"] += gap / 1e6
            end = max(end, e)
        return sorted(([n, v] for n, v in by.items()), key=lambda x: -x[1])[:k]
