"""Wall time per epoch at several substeps per dispatch:
``python -m anoddpm_torch.campaigns.substep_probe [substeps ...] [--root DIR]``
(default 4 8 16).

Counterpart of `scripts/substep_probe.py`: args256syn128 under DIR's
configs/, trained by `train.train` for 16 epochs at `train_substeps` S
(skip_test_eval, no periodic checkpoint), twice per setting, each run in a
fresh temporary directory; run 1 pays the first kernel builds and cuDNN's
choices, run 2 is steady.  The port takes the S steps of a dispatch as
eager steps in a Python loop (`training.make_multi_step`), so what this
measures is the host's cost per call around them.  Appends one JSON line
per setting to ``results/torch_substep_probe.jsonl`` under DIR.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import sys
import tempfile
import time
from typing import Optional, Sequence

from ..bench import card_info, sync
from ..config import load_args
from ..device import DeviceLike, resolve_device
from ..train import train

RESULTS = "results/torch_substep_probe.jsonl"
CONFIG = "256syn128"
EPOCHS = 16
REPS = 2


def run(settings: Sequence[int] = (4, 8, 16), root_dir: str = ".",
        device: DeviceLike = None, epochs: int = EPOCHS, reps: int = REPS,
        config: str = CONFIG, iters_per_epoch: Optional[int] = None):
    device = resolve_device(device)
    card = card_info(device)
    path = os.path.join(root_dir, RESULTS)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    rows = []
    for s in settings:
        args = copy.deepcopy(load_args(config, config_dir=os.path.join(
            root_dir, "configs")))
        args["EPOCHS"] = epochs
        args["train_substeps"] = s
        args["skip_test_eval"] = True
        args["checkpoint_every"] = 10_000   # no periodic checkpoint
        if iters_per_epoch is not None:
            args["iters_per_epoch"] = iters_per_epoch
        walls = []
        for _ in range(reps):
            with tempfile.TemporaryDirectory(prefix=f"substep_probe_{s}_") as tmp:
                t0 = time.perf_counter()
                train(args, root_dir=tmp, max_epochs=epochs, device=device)
                sync(device)
                walls.append(time.perf_counter() - t0)
        row = {"config": config, "substeps": s, "epochs": epochs,
               "iters_per_epoch": int(args["iters_per_epoch"]),
               "batch": int(args["Batch_Size"]),
               "sec_per_epoch_cold": walls[0] / epochs,
               "sec_per_epoch": walls[-1] / epochs, "wall": walls, **card}
        with open(path, "a") as f:
            f.write(json.dumps(row) + "\n")
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


def main(argv=None, device: DeviceLike = None):
    p = argparse.ArgumentParser(prog="python -m anoddpm_torch.campaigns.substep_probe")
    p.add_argument("substeps", nargs="*", type=int)
    p.add_argument("--root", default=".")
    ns = p.parse_args(sys.argv[1:] if argv is None else argv)
    return run(ns.substeps or (4, 8, 16), ns.root, device)


if __name__ == "__main__":
    main()
