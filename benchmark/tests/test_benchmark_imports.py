"""No module a run loads has the top-level name of JAX, its libraries or the
JAX package; the reference loads nothing of the port; without a card the
command prints no result and fails."""

from __future__ import annotations

import ast
import json
import subprocess
import sys

from benchmark import common

RUN_IMPORTS = ("import benchmark.run, benchmark.control, benchmark.client, "
               "benchmark.drivers.train, benchmark.drivers.serve, benchmark.trace, "
               "benchmark.roofline; from benchmark.tests._cells import tiny_train; "
               "from benchmark.drivers import train; import time; "
               "train.run(tiny_train(), 7, 0.2, False, time.perf_counter(), device='cpu'); ")


def fresh(code: str) -> list[str]:
    out = subprocess.run([sys.executable, "-c", code + "import sys, json; "
                          "print(json.dumps(sorted(sys.modules)))"],
                         capture_output=True, text=True, cwd=common.ROOT, timeout=600,
                         env={"PATH": "/usr/bin:/bin", "HOME": str(common.ROOT)})
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_a_run_loads_no_jax_module():
    mods = fresh(RUN_IMPORTS)
    tops = {m.split(".")[0] for m in mods}
    assert "relightable3dgaussians_w_torch" in tops
    assert not tops & set(common.FORBIDDEN_MODULES)


def test_the_reference_loads_nothing_of_the_port():
    mods = fresh("import benchmark.reference.render, benchmark.reference.train, "
                 "benchmark.reference.init, benchmark.reference.lut; ")
    assert not {m for m in mods if m.split(".")[0] == "relightable3dgaussians_w_torch"}
    for path in (common.BENCH_DIR / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                names = [a.name for a in node.names] + [getattr(node, "module", "") or ""]
                assert not any(n.split(".")[0] in ("relightable3dgaussians_w_torch", "benchmark")
                               and not (isinstance(node, ast.ImportFrom) and node.level)
                               for n in names), (path.name, ast.dump(node))


def test_top_level_names_are_compared_whole(monkeypatch):
    fake = {"relightable3dgaussians_w_torch.ops": None, "jaxtyping": None, "flaxen": None}
    monkeypatch.setattr(sys, "modules", fake)
    assert common.forbidden_loaded() == []
    fake["jax.numpy"] = None
    assert common.forbidden_loaded() == ["jax.numpy"]


def test_without_a_card_the_command_prints_no_result(tmp_path):
    import torch

    if torch.cuda.is_available():
        return
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", "train-1m-800",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=common.ROOT, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
