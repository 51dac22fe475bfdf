"""A second seed of the port's base-64 s2d-2 model against the JAX band:
``python -m anoddpm_torch.campaigns.f3_s2d64 [--root DIR]``.

It scores the trained token ``256syn64s2d`` (the dense sweep's model: its
config's seed 0, the 600-epoch recipe of the seed-replication cells) under
the seed-replication protocols of the cells where the port's seed 1 lay
furthest above the JAX package's n = 5 band in Dice (DDPM-200, DDIM-15 and
DDIM-20 at eta = 1), one entry ``{cell}/seed0`` at a time in
``results/torch_f3_s2d64.json`` under DIR, each with the band it is held
against (`band.hold`, mean +- 2 std); a finished entry is skipped.
"""

from __future__ import annotations

import argparse
import sys
from typing import Dict

from ..device import DeviceLike, resolve_device
from . import band
from ._results import F3_S2D64, load_results, save_results
from ._stages import score
from .seed_replication import METRICS, PROTOCOLS

# the model and the seed its config trains it with
TOKEN = "256syn64s2d"
SEED = 0
CELLS = ("s2d64_ddpm200", "s2d64_ddim15_eta1", "s2d64_ddim20_eta1")


def run(root_dir: str = ".", device: DeviceLike = None) -> Dict[str, Dict]:
    device = resolve_device(device)
    res = load_results(root_dir, F3_S2D64)
    for cell in CELLS:
        key = f"{cell}/seed{SEED}"
        if key in res:
            continue
        entry = score(root_dir, TOKEN, PROTOCOLS[cell], METRICS, device)
        res[key] = {**entry, "band": band.hold(entry, cell=cell)}
        save_results(root_dir, F3_S2D64, res)
        print(f"=== {key}: " + band.verdict(entry, cell=cell), flush=True)
    return res


def main(argv=None, device: DeviceLike = None):
    p = argparse.ArgumentParser(prog="python -m anoddpm_torch.campaigns.f3_s2d64")
    p.add_argument("--root", default=".")
    ns = p.parse_args(sys.argv[1:] if argv is None else argv)
    return run(ns.root, device=device)


if __name__ == "__main__":
    main()
