"""Timing helpers of the port's measurement scripts and of chip_smoke.

Counterpart of the JAX repo's `scripts/tputime.py`. JAX needed a 4-byte
scalar pull to be sure a TPU program had finished; here a
`torch.cuda.synchronize()` does that job.

* `timeit`: host wall clock over back-to-back calls, synchronized at both
  ends (end-to-end time: the host's dispatch and the device's work).
* `median_ms`: the median of CUDA-event times around single calls.
* `device_ms`: the device time the calls put on the card (`queued_ms`: the
  calls queued behind a spinning kernel and timed with CUDA events, or
  `profiled_ms`: torch.profiler's kernel sum), which leaves out the host's
  share.

On the CPU `timeit` reads `time.perf_counter` with no synchronize;
`median_ms` and `device_ms` need the card.
"""

from __future__ import annotations

import time

import numpy as np
import torch

SPIN_CYCLES_PER_MS = 2_000_000   # SM clock cycles of torch.cuda._sleep (H100: up to 1.98 GHz)


def sync():
    """Wait for the card's work, where this process has used the card."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


def timeit(f, *args, iters: int = 10, name: str = "", quiet: bool = False):
    """(the last call's output, ms per call) of `iters` calls f(*args) after
    one warm-up call; prints `name` and the time unless quiet."""
    out = f(*args)
    sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        out = f(*args)
    sync()
    dt = (time.perf_counter() - t0) / iters * 1e3
    if not quiet:
        print(f"{name:44s} {dt:9.2f} ms", flush=True)
    return out, dt


def median_ms(fn, iters):
    """Median over `iters` calls of the CUDA-event time around one call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        torch.cuda.synchronize()
        times.append(s.elapsed_time(e))
    return float(np.median(times))


def device_events(prof):
    """The profile's kernel, copy and set events (not the ranges' device spans)."""
    return [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def queued_ms(fn, iters, tries=2):
    """Device time per call of `fn`, or None. Each call's launches are
    queued behind a spinning kernel (`torch.cuda._sleep`), so the card runs
    them back to back once the spin ends, and a CUDA event pair around them
    reads the card's time with no host gap in it (only the card's own gaps
    between back-to-back kernels); the mean over `iters` calls. A call
    counts when the spin still ran after the host had queued it (its start
    event not yet reached). The spin is twice one call's time and doubles once more
    where that was short. None where a call cannot be queued ahead: it waits
    for the card, or its launches fill the launch queue."""
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    spin_ms = max(1.0, 2e3 * (time.perf_counter() - t0))
    total = 0.0
    for _ in range(iters):
        for _ in range(tries):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(int(spin_ms * SPIN_CYCLES_PER_MS))
            start.record()
            fn()
            end.record()
            queued_ahead = not start.query()
            torch.cuda.synchronize()
            if queued_ahead:
                break
            spin_ms *= 2
        else:
            return None
        total += start.elapsed_time(end)
    return total / iters


def profiled_ms(fn, iters, attempts=3):
    """Device time per call of `fn`: the kernels, copies and sets its `iters`
    calls put on the card (torch.profiler, CUPTI), summed, over iters, with
    no gap between kernels in it. A profile that caught no device time is
    taken again; after `attempts` of them it raises, so a time the profiler
    did not see is never reported as 0."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for _ in range(attempts):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        total_us = sum(e.self_device_time_total for e in device_events(prof))
        if total_us > 0:
            return total_us / 1e3 / iters
    raise AssertionError(f"device_ms: {attempts} profiles of {iters} calls caught no device time")


def device_ms(fn, iters):
    """Device time per call of `fn`: `queued_ms` where a call's launches can
    be queued ahead, else `profiled_ms`. Unlike `median_ms` it leaves out the
    host time a call spends before its first launch, which an event pair
    around one short call includes.

    Queued first because the profiler is not reliable late in a long process
    on the card (H100, chip_smoke after its NCCL and serving phases): three
    profiles of 10 calls of a 0.25 ms gather caught no device time, and
    others caught part of their kernels (one read 0.0066 ms, under its
    0.0148 ms byte bound). The queued time holds the gaps the card leaves
    between back-to-back kernels, which the profiler's sum leaves out (the
    preprocess at 1M: 1.94 ms queued against 1.46 profiled)."""
    ms = queued_ms(fn, iters)
    return profiled_ms(fn, iters) if ms is None else ms
