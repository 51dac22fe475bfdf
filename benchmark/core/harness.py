"""One run of one cell: resolve it by name, set it up, measure its window,
trace it when asked, check its outputs against the reference, and print
the result line.

Everything that belongs to one cell is found by name: the cell's entry in
`BENCHMARK.json` gives its configuration (`benchmark/configs/<config>.json`)
and traffic (`benchmark/traffic/<traffic>.json`); the traffic names its
entry (`benchmark/core/entry_<entry>.py`); the limits of its checks are in
`benchmark/limits/<cell>.json`; each metric the cell reports is read by
`benchmark/metrics/<metric>.py`, whose `read(run)` returns a number or
None (then the metric is left out).
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import os
import pathlib
import sys
import time
from typing import Dict, List, Optional, Tuple

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "anoddpm_tpu")


class CellError(RuntimeError):
    """The cell cannot be run here."""


def load_json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest(root: pathlib.Path) -> dict:
    path = root / "BENCHMARK.json"
    if not path.is_file():
        raise CellError(f"{path} not found: run from the root of a checkout")
    return load_json(path)


class Cell:
    """A cell of the manifest with its files."""

    def __init__(self, root: pathlib.Path, name: str):
        self.root = root
        self.bench = root / "benchmark"
        m = manifest(root)
        found = [w for w in m["workloads"] if w["name"] == name]
        if not found:
            raise CellError(f"no workload {name!r} in BENCHMARK.json")
        self.name = name
        self.entry = found[0]
        self.chips = int(self.entry["chips"])
        config = [c for c in m["configs"] if c["name"] == self.entry["config"]][0]
        self.cfg = load_json(root / config["file"])
        self.traffic = load_json(self.bench / "traffic"
                                 / f"{self.entry['traffic']}.json")
        limits = self.bench / "limits" / f"{name}.json"
        self.limits = load_json(limits) if limits.is_file() else {}

        def applies(metric):
            cells = metric.get("workloads")
            return cells is None or name in cells

        self.end_to_end = [x for x in m["end_to_end"] if applies(x)]
        self.per_layer = [x for x in m["per_layer"] if applies(x)]

    def entry_module(self):
        return importlib.import_module(
            f"benchmark.core.entry_{self.traffic['entry']}")


def reader(bench: pathlib.Path, metric: str):
    """`read` of benchmark/metrics/<metric>.py."""
    path = bench / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{metric.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


class Run:
    """What a run measured, for the readers.

    setup_s: process start to the window's start.  window_s: the measured
    window.  units: slices scored or images trained in it; groups, steps:
    the calls in it; group_s: each group's latency; host: the host spans'
    seconds by name, one entry per call; trace: the traced window's
    `trace.Summary` (None with --trace 0)."""

    def __init__(self, cell: Cell, seed: int, seconds: float):
        self.cell, self.cfg, self.traffic = cell, cell.cfg, cell.traffic
        self.seed, self.seconds = seed, seconds
        self.setup_s = self.window_s = self.window_start = 0.0
        self.units = self.attempted = self.failed = 0
        self.group_s: List[float] = []
        self.host: Dict[str, List[float]] = {}
        self.trace = None
        self.memory_peak_bytes = 0

    def add(self, span: str, seconds: float) -> None:
        self.host.setdefault(span, []).append(seconds)


def process_age_s() -> float:
    """Seconds since this process started (from /proc), or 0 where that
    cannot be read."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(uptime - start_ticks / os.sysconf("SC_CLK_TCK"), 0.0)
    except (OSError, ValueError, IndexError):
        return 0.0


def forbidden_modules() -> List[str]:
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def judge(checks: List[Tuple[str, float]], limits: Dict[str, float]):
    """(correct, {name: {"value", "limit"}}): correct when every number
    that the cell's limits name was read and lies at or under its limit
    (not NaN); a number that no limit names is printed with the limit None
    and decides nothing."""
    read = dict(checks)
    out = {name: {"value": value, "limit": limits.get(name)}
           for name, value in checks}
    ok = bool(limits)
    for name, limit in limits.items():
        value = read.get(name)
        ok &= value is not None and value == value and value <= limit
    return ok, out


def execute(cell: Cell, seed: int, seconds: float, traced: bool, device,
            age0: float = 0.0, started: Optional[float] = None):
    """Run the cell once on `device`; returns (run, entry).  The process
    was `age0` seconds old at `started` (perf_counter)."""
    started = time.perf_counter() if started is None else started
    run = Run(cell, seed, seconds)
    entry = cell.entry_module().Entry(cell, run, seed, device)
    entry.setup()
    entry.measure(seconds)
    run.setup_s = age0 + run.window_start - started
    if traced:      # after the window, which the profiler never touches
        entry.traced()
    return run, entry


def finish(run: Run, entry, device, control: Optional[str] = None):
    """Read the peak, free the program and return the check's numbers
    (`entry.check`; `control` puts a stand-in in the program's place)."""
    import torch
    if device.type == "cuda":
        run.memory_peak_bytes = int(torch.cuda.max_memory_allocated(device))
    entry.release()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return entry.check(control)


def main(argv=None) -> int:
    import argparse
    age0, started = process_age_s(), time.perf_counter()
    p = argparse.ArgumentParser(prog="python3 benchmark/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ns = p.parse_args(argv)
    root = pathlib.Path.cwd()
    try:
        cell = Cell(root, ns.workload)
        import anoddpm_torch  # noqa: F401  (the system under test)
    except (CellError, ImportError, OSError, KeyError) as exc:
        print(f"benchmark: {exc}", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"benchmark: the cell needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    run, entry = execute(cell, ns.seed, ns.seconds, bool(ns.trace), device,
                         age0, started)
    checks = finish(run, entry, device)
    found = forbidden_modules()
    if found:
        print(f"benchmark: the process holds {', '.join(found)}",
              file=sys.stderr)
        return 4
    line = result_line(cell, run, checks, bool(ns.trace), {
        "platform": "gpu", "kind": torch.cuda.get_device_name(device),
        "count": cell.chips, "memory_peak_bytes": run.memory_peak_bytes})
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


def result_line(cell: Cell, run: Run, checks, traced: bool, device: dict):
    """The result's JSON object: `correct`, `attempted`, `failed`, the
    cell's end-to-end (or, traced, per-layer) metrics, `device`, with a
    trace the `breakdown`, and last the numbers compared with limits."""
    correct, compared = judge(checks, cell.limits)
    metrics = {}
    for m in (cell.per_layer if traced else cell.end_to_end):
        value = reader(cell.bench, m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    line = {"correct": correct, "attempted": run.attempted,
            "failed": run.failed, "metrics": metrics, "device": device}
    if traced and run.trace is not None:
        device["busy_s"] = run.trace.busy_s
        device["window_s"] = run.trace.window_s
        line["breakdown"] = run.trace.breakdown()
    line["checks"] = compared
    return line
