"""A configuration, a cell and a per-layer metric added as new files (and
entries of the manifest) in a copy of the benchmark, found by the harness
with no file of the benchmark edited."""

import json
import shutil

from benchmark.core import harness
from benchmark.tests.tiny import ROOT


def test_added_files_are_found(tmp_path):
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    m = json.loads((ROOT / "BENCHMARK.json").read_text())
    before = {p.relative_to(tmp_path): p.read_bytes()
              for p in (tmp_path / "benchmark").rglob("*") if p.is_file()}
    cfg = json.loads((ROOT / "benchmark/configs/paper128.json").read_text())
    cfg["img_size"] = [128, 128]
    (tmp_path / "benchmark/configs/paper128_128.json").write_text(json.dumps(cfg))
    (tmp_path / "benchmark/traffic/detect.ddpm50.b4.json").write_text(json.dumps(
        {"entry": "detect", "sampler": "ddpm", "lambda": 50,
         "volumes_per_group": 1, "slices_per_volume": 4, "pool_volumes": 4,
         "warm_lambda": 2, "check_groups": 1, "trace_groups": 1}))
    (tmp_path / "benchmark/limits/paper128_128.detect.ddpm50.b4.json").write_text(
        json.dumps({"map_gap": 0.05}))
    (tmp_path / "benchmark/metrics/groups.detect.py").write_text(
        "def read(run):\n    return float(len(run.group_s)) or None\n")
    m["configs"].append({"name": "paper128_128", "source": "https://example.org",
                         "file": "benchmark/configs/paper128_128.json",
                         "reduced": [], "why": "a smaller image"})
    m["workloads"].append({"name": "paper128_128.detect.ddpm50.b4",
                           "config": "paper128_128", "traffic": "detect.ddpm50.b4",
                           "chips": 1, "why": "a new cell"})
    m["per_layer"].append({"name": "groups.detect", "unit": "groups",
                           "better": "higher", "source": "host_clock",
                           "layer": "detection entry",
                           "moves": "detect_slices_per_s",
                           "workloads": ["paper128_128.detect.ddpm50.b4"]})
    m["end_to_end"][0]["workloads"].append("paper128_128.detect.ddpm50.b4")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(m))

    cell = harness.Cell(tmp_path, "paper128_128.detect.ddpm50.b4")
    assert cell.cfg["img_size"] == [128, 128]
    assert cell.traffic["lambda"] == 50 and cell.limits == {"map_gap": 0.05}
    assert [x["name"] for x in cell.per_layer] == ["groups.detect"]
    run = harness.Run(cell, 1, 1.0)
    run.group_s = [0.5, 0.6]
    assert harness.reader(cell.bench, "groups.detect")(run) == 2.0
    after = {p.relative_to(tmp_path): p.read_bytes()
             for p in (tmp_path / "benchmark").rglob("*") if p.is_file()}
    assert all(after[k] == v for k, v in before.items())
