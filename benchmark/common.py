"""What every cell of the benchmark shares: finding a cell and its files by
name, seeds, the card's description, the check that no JAX module was
loaded, and the result line.

A cell (`BENCHMARK.json` "workloads") names a configuration, found as the
file its `configs` entry names, and a traffic mix, found as
`benchmark/traffic/<traffic>.json`. The mix's "kind" picks the driver
(`benchmark/drivers/<kind>.py`), and the cell's limits for `correct` are
`benchmark/limits/<cell>.json`. Per-layer metrics are readers found as
`benchmark/metrics/<metric>.py`.
"""

from __future__ import annotations

import hashlib
import importlib.util
import json
import os
import re
import subprocess
import sys
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
CACHE_DIR = ROOT / "build" / "benchmark"      # fixed, inside the checkout

NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
# Modules that may not be loaded in a run: the JAX stack and the JAX package,
# compared by their whole top-level name.
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "optax", "relightable3dgaussians_w_tpu")


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def load_cell(name: str, root: Path = ROOT, bench: dict | None = None) -> dict:
    """The workload `name` with "config_data", "traffic_data", "limits" and its
    "end_to_end" / "per_layer" metric entries (those that list it, or list no
    workloads)."""
    bench = bench or load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {sorted(cells)})")
    cell = dict(cells[name])
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    with open(root / conf["file"]) as f:
        cell["config_data"] = json.load(f)
    with open(root / "benchmark" / "traffic" / f"{cell['traffic']}.json") as f:
        cell["traffic_data"] = json.load(f)
    with open(root / "benchmark" / "limits" / f"{name}.json") as f:
        cell["limits"] = json.load(f)
    listed = lambda m: name in m.get("workloads", [name])
    cell["end_to_end"] = [m for m in bench["end_to_end"] if listed(m)]
    cell["per_layer"] = [m for m in bench["per_layer"] if listed(m)]
    return cell


def load_module(path: Path, name: str):
    """Import a file by path (names may hold dots: `mfu.train.py`)."""
    spec = importlib.util.spec_from_file_location(f"benchmark_plugin_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str, root: Path = ROOT):
    return load_module(root / "benchmark" / "metrics" / f"{name}.py", name)


def derive_seed(seed: int, tag: str) -> int:
    """A 62-bit seed for one use of the run's seed (any integer)."""
    h = hashlib.sha256(f"{seed}:{tag}".encode()).digest()
    return int.from_bytes(h[:8], "little") >> 2


def set_cache_dirs():
    """Every compile cache at a fixed path inside the checkout. The port builds
    its kernels into build/kernels and its host library into build/native by
    itself; Triton's and torch's extension caches are pinned here too."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(CACHE_DIR / sub)


def card_power_limit() -> str | None:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else None
    except (OSError, subprocess.TimeoutExpired, IndexError):
        return None


def forbidden_loaded() -> list[str]:
    """Loaded modules whose top-level name is one of FORBIDDEN_MODULES."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN_MODULES})


def emit(result: dict, checks: dict):
    """Print each compared number beside its limit on stderr, last, and the
    result line (checks as its last key) as the last line of stdout."""
    for k, v in checks.items():
        print(f"check {k}: {v['value']!r} limit {v['limit']!r}", file=sys.stderr, flush=True)
    line = dict(result)
    line["checks"] = checks
    print(json.dumps(line), flush=True)
