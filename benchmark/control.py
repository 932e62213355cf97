"""The control of `correct`: a cell's run with the reference computed with TF32
matrix products (the precision below the configurations' float32, TF32 off)
put in the program's place, on several seeds, at the cell's own size; or,
with --fault, a run with a fault planted in the timed path.

    python3 -m benchmark.control --workload NAME --seeds 1,2,3 [--seconds S] [--fault F]

Prints one JSON line a seed with the numbers compared and their limits. Each
has to come out not correct: the readings it prints are the upper readings
the limits in `benchmark/limits/` sit below (PERF.md). The benchmark's own
runs never run it. A training cell needs no measured window; a serving cell
a short one at the cell's own load.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
import time


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m benchmark.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--fault", default="control",
                   help="control (the default), or a fault planted in the timed path: "
                        "state_unchanged, half_batch (training), frame_altered (serving)")
    args = p.parse_args(argv)
    from . import common

    common.set_cache_dirs()
    cell = common.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    driver = importlib.import_module(f"benchmark.drivers.{cell['traffic_data']['kind']}")
    failed_all = True
    for seed in [int(s) for s in args.seeds.split(",")]:
        res, checks = driver.run(cell, seed, args.seconds, False, time.perf_counter(),
                                 faults=(args.fault,))
        print(json.dumps({"workload": args.workload, "fault": args.fault, "seed": seed,
                          "correct": res["correct"],
                          "checks": checks}), flush=True)
        failed_all &= not res["correct"]
    return 0 if failed_all else 1


if __name__ == "__main__":
    sys.exit(main())
