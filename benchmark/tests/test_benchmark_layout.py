"""BENCHMARK.json against the benchmark's contract, and the data-driven
layout: every cell, configuration, traffic mix, limit file and per-layer
metric is found by its name, and a cell added only as new files and entries
loads and runs through the same code."""

from __future__ import annotations

import json
import re

import pytest

from benchmark import common
from benchmark.tests._cells import checkout_with_tiny_cell

BENCH = common.load_benchmark()
LINE = re.compile(r"^[^\n\t]{1,200}$")


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "-m", "benchmark.run"]
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_are_unique_and_well_formed(section):
    names = [e["name"] for e in BENCH[section]]
    assert len(names) == len(set(names))
    assert all(common.NAME_RE.match(n) for n in names)


def test_metrics_units_sources_and_bounds():
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert common.UNIT_RE.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
    assert any(m["name"] == "setup_s" and "workloads" not in m for m in BENCH["end_to_end"])
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert LINE.match(m["layer"])
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}


def test_every_cell_finds_its_files_and_reports_what_its_metrics_move():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for w in BENCH["workloads"]:
        assert w["chips"] in (1, 4) and LINE.match(w["why"])
        cell = common.load_cell(w["name"])
        reported = {m["name"] for m in cell["end_to_end"]}
        assert "setup_s" in reported and len(reported) >= 2
        assert cell["per_layer"], w["name"]
        for m in cell["per_layer"]:
            assert m["moves"] in reported, (w["name"], m["name"])
            assert callable(common.metric_reader(m["name"]).read)
        assert cell["traffic_data"]["kind"] in ("train", "serve")
        assert set(cell["limits"]) and all(v >= 0 for v in cell["limits"].values())
    for m in BENCH["per_layer"]:
        for w in m.get("workloads", []):
            assert w in {c["name"] for c in BENCH["workloads"]}
        assert m["moves"] in e2e


def test_configs_hold_their_sizes_and_are_used():
    used = {w["config"] for w in BENCH["workloads"]}
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    for c in BENCH["configs"]:
        assert c["name"] in used and c["file"].startswith("benchmark/")
        assert LINE.match(c["source"]) and LINE.match(c["why"])
        data = json.loads((common.ROOT / c["file"]).read_text())
        assert data["name"] == c["name"] and data["reduced"] == c["reduced"]
        m = data["model"]
        assert (m["envlight_sh_degree"], m["sky_sh_degree"], m["embeddings_dim"],
                m["mlp_dense"]) == (4, 1, 32, 256)


def test_a_cell_added_by_files_alone_loads(tmp_path):
    root = checkout_with_tiny_cell(tmp_path)
    cell = common.load_cell("serve-tiny", root=root)
    assert cell["traffic_data"]["yaw_step_deg"] == 2.0
    assert cell["config_data"]["scene"]["width"] == 64
    assert [m["name"] for m in cell["per_layer"]] == ["entries_per_frame.serve"]
    assert {m["name"] for m in cell["end_to_end"]} == {"frames_per_s", "frame_ms_p95",
                                                       "setup_s"}
    reader = common.metric_reader("entries_per_frame.serve", root=root)
    assert reader.read(type("Ctx", (), {"info": {"entries": 7}})()) == 7
