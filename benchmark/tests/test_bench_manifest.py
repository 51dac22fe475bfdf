"""The manifest against the benchmark's required shape, and every name it holds
resolved to a file of the benchmark."""

import json
import re

import pytest

from benchmark.core import harness
from benchmark.tests.tiny import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
M = json.loads((ROOT / "BENCHMARK.json").read_text())
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}


def test_keys_and_names():
    assert set(M) == TOP
    assert M["command"] == ["python3", "benchmark/run.py"]
    assert M["paths"] == ["benchmark"]
    assert 1 <= M["run_seconds"] <= 51
    names = []
    for c in M["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and (ROOT / c["file"]).is_file()
        assert all(NAME.match(k) for k in c["reduced"])
        names.append(c["name"])
    for w in M["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        names += [w["name"], w["traffic"]]
    for m in M["end_to_end"] + M["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        names.append(m["name"])
    assert all(NAME.match(n) for n in names)
    assert len({w["name"] for w in M["workloads"]}) == len(M["workloads"])
    assert len({(w["config"], w["traffic"]) for w in M["workloads"]}) == len(M["workloads"])


def test_bounds():
    for m in M["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" and "workloads" not in m
               for m in M["end_to_end"])


@pytest.mark.parametrize("cell", [w["name"] for w in M["workloads"]])
def test_cell_resolves(cell):
    c = harness.Cell(ROOT, cell)
    assert c.cfg and c.traffic["entry"] in ("detect", "train")
    assert c.entry_module().Entry
    assert c.limits, "every cell's check has limits"
    reported = {m["name"] for m in c.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2
    assert c.per_layer
    for m in c.end_to_end + c.per_layer:
        assert callable(harness.reader(c.bench, m["name"]))
    for m in c.per_layer:
        assert m["moves"] in reported


def test_metric_workloads_name_cells():
    cells = {w["name"] for w in M["workloads"]}
    for m in M["end_to_end"] + M["per_layer"]:
        assert set(m.get("workloads", cells)) <= cells
    layers = {}
    for m in M["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        layers.setdefault(m["layer"], []).append(m["name"])
    for cfg in M["configs"]:
        assert any(w["config"] == cfg["name"] for w in M["workloads"])
