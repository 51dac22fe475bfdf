"""The result line's keys and the judgement of the checks."""

from benchmark.core import harness
from benchmark.tests.tiny import ROOT


def test_judge():
    limits = {"a": 1.0, "b": 2.0}
    assert harness.judge([("a", 0.5), ("b", 2.0), ("c", 9.0)], limits)[0]
    assert not harness.judge([("a", 0.5)], limits)[0]
    assert not harness.judge([("a", 0.5), ("b", float("nan"))], limits)[0]
    assert not harness.judge([("a", 1.5), ("b", 1.0)], limits)[0]
    assert not harness.judge([("a", 0.0)], {})[0]
    _, out = harness.judge([("a", 0.5), ("c", 9.0)], limits)
    assert out == {"a": {"value": 0.5, "limit": 1.0},
                   "c": {"value": 9.0, "limit": None}}


def test_last_line_keys():
    cell = harness.Cell(ROOT, "paper128.detect.ddpm200.b8")
    run = harness.Run(cell, 1, 1.0)
    run.units, run.window_s, run.setup_s = 32, 0.5, 12.0
    run.group_s, run.attempted = [0.25, 0.25], 2
    checks = [(k, v / 2) for k, v in cell.limits.items()]
    dev = {"platform": "gpu", "kind": "x", "count": 1, "memory_peak_bytes": 1}
    line = harness.result_line(cell, run, checks, False, dev)
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert line["correct"] is True
    assert set(line["metrics"]) == {"detect_slices_per_s", "setup_s"}
    assert line["metrics"]["detect_slices_per_s"] == {"value": 64.0,
                                                      "unit": "slices/s"}
