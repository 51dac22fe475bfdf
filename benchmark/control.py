"""The readings that a cell's limits are set from, on the card:

    python3 benchmark/control.py --workload <cell> --mode <mode>[,<mode>...] --seeds 1,2,3 [--seconds 0]

For each seed, one run of the cell (a window of `--seconds`: 0 gives one
detection group, or a train state's set-up steps and one step), then its
check with each `--mode` in the program's place: "program" (the port
itself, the sound runs' lower reading), "fp8" (the reference with fp8
operands, the control), "half_batch" (train: the reference's loss over
half of the rows, a fault).  Prints one JSON line per seed and mode and
the largest and smallest reading of each number by mode.  The benchmark's
own runs do not run it.
"""

import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path[0] = str(ROOT)

import torch  # noqa: E402

from benchmark.core import harness  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 benchmark/control.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--mode", default="program",
                   help="program, fp8, half_batch; several joined by commas")
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=0.0)
    ns = p.parse_args(argv)
    modes = ns.mode.split(",")
    if not set(modes) <= {"program", "fp8", "half_batch"}:
        p.error(f"unknown mode in {ns.mode!r}")
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    cell = harness.Cell(ROOT, ns.workload)
    readings = {}
    for seed in (int(s) for s in ns.seeds.split(",")):
        t0 = time.perf_counter()
        run, entry = harness.execute(cell, seed, ns.seconds, False, device)
        for k, mode in enumerate(modes):
            control = None if mode == "program" else mode
            checks = (harness.finish(run, entry, device, control) if k == 0
                      else entry.check(control))
            for name, value in checks:
                readings.setdefault(mode, {}).setdefault(name, []).append(value)
            print(json.dumps({"workload": ns.workload, "mode": mode,
                              "seed": seed, "steps": run.attempted,
                              "checks": dict(checks),
                              "seconds": time.perf_counter() - t0}), flush=True)
        del run, entry
    for mode, by_name in readings.items():
        print(json.dumps({"workload": ns.workload, "mode": mode,
                          "max": {k: max(v) for k, v in by_name.items()},
                          "min": {k: min(v) for k, v in by_name.items()}}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
