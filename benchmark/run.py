"""Benchmark of the PyTorch/CUDA port of relightable 3DGS-W.

    python3 -m benchmark.run --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout, on a machine with an NVIDIA card. One run builds
the cell's inputs from the seed, warms up the cell's own shapes (set-up,
reported as `setup_s`), measures for `--seconds`, checks what the timed path
produced against the plain reference (`correct`), and prints one JSON line
last: with `--trace 0` the cell's end-to-end metrics, with `--trace 1` its
per-layer metrics, read from a profiled slice of the window. It exits non-zero
with no result where there is no card or too few, and where a JAX module was
loaded. See benchmark/README.md for the layout and how to add to it.
"""

from __future__ import annotations

import argparse
import importlib
import json
import math
import sys
import time

T_START = time.perf_counter()


def parse(argv):
    p = argparse.ArgumentParser(prog="python3 -m benchmark.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def per_layer(cell, ctx) -> dict:
    """Each per-layer metric of the cell from its reader; a reader that finds
    nothing to read returns None and the metric is left out."""
    from . import common

    out = {}
    for m in cell["per_layer"]:
        v = common.metric_reader(m["name"]).read(ctx)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def main(argv=None) -> int:
    args = parse(sys.argv[1:] if argv is None else argv)
    from . import common

    common.set_cache_dirs()
    cell = common.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"benchmark: {cell['chips']} CUDA device(s) needed, "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
              file=sys.stderr)
        return 2
    # every configuration states float32 with TF32 off
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = cell["traffic_data"]["kind"]
    driver = importlib.import_module(f"benchmark.drivers.{kind}")
    result, checks = driver.run(cell, args.seed, args.seconds, bool(args.trace), T_START)

    metrics = {}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell["chips"], "memory_peak_bytes": int(result["peak"]),
              "power_limit": common.card_power_limit()}
    line = {"correct": bool(result["correct"]), "attempted": int(result["attempted"]),
            "failed": int(result["failed"])}
    if args.trace:
        ctx = result["trace"]
        metrics = per_layer(cell, ctx)
        device["busy_s"] = ctx.busy_s()
        device["window_s"] = ctx.window_s
        line["breakdown"] = {"device_ops": ctx.top_device_ops(), "idle_gaps": ctx.idle_gaps()}
    else:
        names = {m["name"] for m in cell["end_to_end"]}
        metrics = {k: {"value": v, "unit": u["unit"]} for u in cell["end_to_end"]
                   for k, v in result["metrics"].items() if k == u["name"]}
        metrics["setup_s"] = {"value": result["setup_s"], "unit": "s"}
        missing = names - set(metrics)
        if missing:
            raise RuntimeError(f"the driver measured no {sorted(missing)}")
        if not all(math.isfinite(m["value"]) for m in metrics.values()):
            line["correct"] = False
    line["metrics"] = metrics
    line["device"] = device
    print("benchmark details: " + json.dumps(result.get("details", {}), default=float),
          file=sys.stderr)
    found = common.forbidden_loaded()
    if found:
        print(f"benchmark: JAX modules were loaded: {found}", file=sys.stderr)
        return 3
    common.emit(line, checks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
