"""BENCHMARK.json against the benchmark's contract, the files it names, and
the last line a run prints."""

import importlib
import json
import os
import re

import pytest

from benchmark import run
from benchmark.tests import tiny

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
B = tiny.BENCH


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_command():
    assert set(B) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert B["command"] == ["python3", "benchmark/run.py"] and B["paths"] == ["benchmark"]
    assert isinstance(B["run_seconds"], int) and 1 <= B["run_seconds"] <= 51
    cells = len(B["workloads"])
    assert 2 + 14 * 24 * (B["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200 or cells < 24
    assert os.path.getsize(os.path.join(run.ROOT, "BENCHMARK.json")) <= 64 << 10


def test_configs_name_their_files_and_reduced_keys():
    for c in B["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert c["file"].startswith("benchmark/") and _line(c["why"]) and _line(c["source"])
        config = run.load(c["file"])
        assert config["name"] == c["name"]
        assert all(NAME.match(k) and k in config and k in config["reduced"] for k in c["reduced"])
        assert any(w["config"] == c["name"] for w in B["workloads"])


def test_cells_name_their_files():
    pairs = set()
    for w in B["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and _line(w["why"])
        assert w["chips"] in (1, 4) and (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        cell, config, traffic, limits = run.cell_inputs(B, w["name"])
        assert importlib.import_module(f"benchmark.jobs.{config['job']}").Job
        assert limits and all(isinstance(v, (int, float)) for v in limits.values())


def test_metrics():
    names = set()
    for m in B["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
        names.add(m["name"])
    assert "setup_s" in names
    layers = {}
    for m in B["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in names and UNIT.match(m["unit"]) and _line(m["layer"])
        assert importlib.import_module(f"benchmark.metrics.{m['name'].split('.')[0]}").read
        layers.setdefault(m["layer"], []).append(m["name"])
        for w in m.get("workloads", []):
            assert w in tiny.CELLS
    all_names = [m["name"] for m in B["end_to_end"] + B["per_layer"]]
    assert len(set(all_names)) == len(all_names) and all(NAME.match(n) for n in all_names)
    for w in tiny.CELLS:
        assert any(run.applies(m, w) for m in B["per_layer"])


@pytest.mark.parametrize("workload", tiny.CELLS)
def test_last_line(workload, capsys):
    result, checks = tiny.run_tiny(workload)
    line = json.loads(json.dumps(result))
    assert list(line)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert isinstance(line["correct"], bool) and line["attempted"] >= 1
    assert set(line["metrics"]) == {m["name"] for m in B["end_to_end"] if run.applies(m, workload)}
    for v in line["metrics"].values():
        assert set(v) == {"value", "unit"} and v["value"] > 0 or v["unit"] == "GiB"
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    assert set(checks) == set(run.cell_inputs(B, workload)[3])
    assert all(len(v) == 2 for v in line["checks"].values())
