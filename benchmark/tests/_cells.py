"""Tiny cells for the benchmark's CPU tests, made from the committed ones
with their sizes cut, and a cell defined only in test data."""

from __future__ import annotations

import copy
import json
import shutil
from pathlib import Path

from benchmark import common


def tiny_train() -> dict:
    c = copy.deepcopy(common.load_cell("train-1m-800"))
    c["config_data"]["scene"].update(n_foreground=3000, width=64, height=64)
    c["config_data"]["runtime"]["pool_headroom"] = 2.0
    c["traffic_data"].update(photos=4, start_sample=64)
    return c


def tiny_serve() -> dict:
    c = copy.deepcopy(common.load_cell("serve-3m-1600"))
    c["config_data"]["scene"].update(n_foreground=3000, n_sky=100, width=96, height=64)
    c["traffic_data"].update(yaw_step_deg=5.0, sample_frames=3)
    return c


def checkout_with_tiny_cell(tmp: Path) -> Path:
    """A checkout whose BENCHMARK.json adds a cell ("serve-tiny") with a
    configuration, a traffic mix, limits and a per-layer metric that exist
    only as new files and entries here."""
    root = tmp / "checkout"
    shutil.copytree(common.BENCH_DIR, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = common.load_benchmark()
    conf = json.loads((common.ROOT / "benchmark/configs/relit3dgsw-3m-1600.json").read_text())
    conf["name"] = "relit3dgsw-tiny"
    conf["scene"].update(n_foreground=2000, n_sky=50, width=64, height=48)
    (root / "benchmark/configs/relit3dgsw-tiny.json").write_text(json.dumps(conf))
    traffic = json.loads((common.ROOT / "benchmark/traffic/serve_orbit.json").read_text())
    traffic.update(yaw_step_deg=2.0, yaw_range=[-4.0, 4.0])
    (root / "benchmark/traffic/serve_sweep_small.json").write_text(json.dumps(traffic))
    (root / "benchmark/limits/serve-tiny.json").write_text(
        json.dumps({"bytes_differ_share": 1e-3}))
    (root / "benchmark/metrics/entries_per_frame.serve.py").write_text(
        '"""Mean entries a traced frame."""\n\ndef read(ctx):\n    return ctx.info.get("entries")\n')
    bench["configs"].append({"name": "relit3dgsw-tiny", "source": "test data",
                             "file": "benchmark/configs/relit3dgsw-tiny.json", "reduced": [],
                             "why": "a test"})
    bench["workloads"].append({"name": "serve-tiny", "config": "relit3dgsw-tiny",
                               "traffic": "serve_sweep_small", "chips": 1, "why": "a test"})
    for m in bench["end_to_end"]:
        if m["name"] in ("frames_per_s", "frame_ms_p95"):
            m["workloads"].append("serve-tiny")
    bench["per_layer"].append({"name": "entries_per_frame.serve", "unit": "entries",
                               "better": "lower", "source": "program_counter",
                               "layer": "rasterizer (ops/rasterize.py)",
                               "moves": "frames_per_s", "workloads": ["serve-tiny"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root
