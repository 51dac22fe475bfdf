"""Cells of the manifest cut to a size a CPU test can hold: 32x32 slices,
base 32, no space-to-depth, batch 2, short chains."""

from __future__ import annotations

import pathlib

import torch

from benchmark.core import harness

ROOT = pathlib.Path(__file__).resolve().parents[2]
CPU = torch.device("cpu")
SEED = 2 ** 33 + 7          # above 32 bits, as a check's seeds may be

TRAFFIC = {
    "detect": {"lambda": 5, "warm_lambda": 2, "ddim_steps": 3, "warm_steps": 2,
               "pool_volumes": 3, "volumes_per_group": 1, "check_groups": 1,
               "check_slices": 2,
               "trace_steps": 2, "trace_groups": 1},
    "train": {"pool_slices": 8, "trace_steps": 2},
}
# at 32^2 and base 32 on the CPU: well above the sound readings (map_gap
# ~0.013-0.018, metric_gap 0, step 1's loss gap ~0.002, grad_gap ~0.02, the
# late stage's ~0.002 and ~0.05) and below those of the fp8 control and the
# faults
LIMITS = {"detect": {"map_gap": 0.06, "metric_gap": 0.0},
          "train": {"loss_gap_step1": 0.01, "grad_gap": 0.08,
                    "late_loss_gap_step1": 0.01, "late_grad_gap": 0.15}}


def cell(name: str) -> harness.Cell:
    c = harness.Cell(ROOT, name)
    c.cfg.update({"img_size": [32, 32], "base_channels": 32,
                  "space_to_depth": 1, "Batch_Size": 2})
    for key, value in TRAFFIC[c.traffic["entry"]].items():
        if key in c.traffic:
            c.traffic[key] = value
    c.limits = dict(LIMITS[c.traffic["entry"]])
    return c


def run(name: str, traced: bool = False, control=None, seconds: float = 0.0):
    """(correct, checks, run) of one tiny run of cell `name` on the CPU."""
    c = cell(name)
    r, entry = harness.execute(c, SEED, seconds, traced, CPU)
    checks = harness.finish(r, entry, CPU, control)
    correct, _ = harness.judge(checks, c.limits)
    return correct, dict(checks), r
