"""Seed-replicated quality evidence:
``python -m anoddpm_torch.campaigns.seed_replication [seeds...]
[--skip=a,b] [--root DIR]`` (seeds 0 1 2 3 4 by default).

Counterpart of `scripts/seed_replication.py`.  Each model cell trains
fresh seeds end to end through `train.train` (8 steps per dispatch, token
``{config}_s{seed}``); then every protocol cell is evaluated on every seed
through the detection path, cheapest first (DDIM by its step count, DDPM
at 200), and the aggregates are taken over every seed in the file.
Results go to ``results/torch_seed_replication.json`` under DIR, one entry
``{cell}/seed{n}`` at a time (a rerun skips finished entries).  `--skip`
leaves out the cells whose names contain one of its substrings.
"""

from __future__ import annotations

import argparse
import copy
import os
import sys
from typing import Dict, List, Sequence, Tuple

import numpy as np

from ..config import load_args
from ..detect import _load_eval_model, anomalous_metric_calculation
from ..device import DeviceLike, resolve_device
from ..train import train
from ._results import SEED_REPLICATION, load_results, save_results

# model cells: config token -> the protocol cells evaluated on it.  The
# "_diffuse" cells score the same seeds on the low-frequency lesion family.
MODELS = {
    "256syn128": ["paper128_ddpm200", "paper128_ddpm200_diffuse"],
    "256syn64s2d": [
        "s2d64_ddim15_eta1",
        "s2d64_ddim20_eta1",
        "s2d64_ddim25_eta1",
        "s2d64_ddim35_eta1",
        "s2d64_ddpm200",
        "s2d64_ddim12x2_eta1",
        "s2d64_ddim8x3_eta1",
        "s2d64_ddim25_eta1_diffuse",
        "s2d64_ddim15_eta1_diffuse",
    ],
}
PROTOCOLS = {
    "paper128_ddpm200": {"sampler": "ddpm"},
    "s2d64_ddpm200": {"sampler": "ddpm"},
    "s2d64_ddim15_eta1": {"sampler": "ddim", "ddim_steps": 15,
                          "ddim_eta": 1.0},
    "s2d64_ddim20_eta1": {"sampler": "ddim", "ddim_steps": 20,
                          "ddim_eta": 1.0},
    "s2d64_ddim25_eta1": {"sampler": "ddim", "ddim_steps": 25,
                          "ddim_eta": 1.0},
    "s2d64_ddim35_eta1": {"sampler": "ddim", "ddim_steps": 35,
                          "ddim_eta": 1.0},
    # mean of k reconstructions at the step budget of one DDIM-24
    "s2d64_ddim12x2_eta1": {"sampler": "ddim", "ddim_steps": 12,
                            "ddim_eta": 1.0, "recon_repeats": 2},
    "s2d64_ddim8x3_eta1": {"sampler": "ddim", "ddim_steps": 8,
                           "ddim_eta": 1.0, "recon_repeats": 3},
    "paper128_ddpm200_diffuse": {"sampler": "ddpm",
                                 "lesion_kind": "diffuse",
                                 "lesion_severity": 1.5},
    "s2d64_ddim25_eta1_diffuse": {"sampler": "ddim", "ddim_steps": 25,
                                  "ddim_eta": 1.0,
                                  "lesion_kind": "diffuse",
                                  "lesion_severity": 1.5},
    "s2d64_ddim15_eta1_diffuse": {"sampler": "ddim", "ddim_steps": 15,
                                  "ddim_eta": 1.0,
                                  "lesion_kind": "diffuse",
                                  "lesion_severity": 1.5},
}
METRICS = ("auc", "dice", "ssim", "iou")
SUBSTEPS = 8


def train_args_for(config: str, seed: int, root_dir: str = "."):
    """configs/args{config}.json under `root_dir` with the seed, 8 substeps
    and the token {config}_s{seed}."""
    args = copy.deepcopy(load_args(config,
                                   config_dir=os.path.join(root_dir, "configs")))
    args["seed"] = seed
    args["train_substeps"] = SUBSTEPS
    args["arg_num"] = f"{config}_s{seed}"
    return args


def ensure_trained(config: str, seed: int, root_dir: str = ".",
                   device: DeviceLike = None) -> str:
    """Train {config}_s{seed} unless its params-final exists; its token."""
    args = train_args_for(config, seed, root_dir)
    token = args["arg_num"]
    final = os.path.join(root_dir, "model", f"diff-params-ARGS={token}",
                         "params-final", "payload.msgpack")
    if not os.path.exists(final):
        print(f"=== training {token} ({args['EPOCHS']} epochs)", flush=True)
        train(args, root_dir=root_dir, device=device)
    return token


def kept_cells(config: str, skip: Sequence[str] = ()) -> List[str]:
    """The cells of `config` whose names hold no substring of `skip`."""
    return [cell for cell in MODELS[config]
            if not any(s in cell for s in skip)]


def work_list(res, seeds: Sequence[int],
              skip: Sequence[str] = ()) -> List[Tuple[int, str, str, int]]:
    """(cost, config, cell, seed) of every entry not yet in `res`, cheapest
    first; a cell whose name holds a substring of `skip` is left out."""
    work = []
    for config in MODELS:
        for cell in kept_cells(config, skip):
            for seed in seeds:
                if f"{cell}/seed{seed}" not in res:
                    cost = PROTOCOLS[cell].get("ddim_steps", 200)
                    work.append((cost, config, cell, seed))
    return sorted(work)


def seed_entries(res, cell: str) -> Dict[int, Dict[str, float]]:
    """{n: entry} of every {cell}/seed{n} entry in `res`."""
    prefix = f"{cell}/seed"
    return {int(k[len(prefix):]): v for k, v in res.items()
            if k.startswith(prefix) and k[len(prefix):].isdigit()}


def aggregate(res, seeds=None, cells=None) -> None:
    """Write {cell}/aggregate (mean, population std, n per metric) over
    every {cell}/seed{n} entry in `res`, whatever `seeds` a run was given,
    so that a one-seed catch-up never overwrites an aggregate of n = 5;
    for every cell of MODELS, or for `cells`."""
    del seeds
    for cells in ([cells] if cells is not None else MODELS.values()):
        for cell in cells:
            entries = seed_entries(res, cell)
            vals = {m: [entries[s][m] for s in sorted(entries)]
                    for m in METRICS}
            if not vals["auc"]:
                continue
            res[f"{cell}/aggregate"] = {
                m: {"mean": float(np.mean(v)), "std": float(np.std(v)),
                    "n": len(v)}
                for m, v in vals.items()}
            a = res[f"{cell}/aggregate"]
            print(f"{cell}: AUC {a['auc']['mean']:.4f}"
                  f"+-{a['auc']['std']:.4f}  "
                  f"Dice {a['dice']['mean']:.4f}"
                  f"+-{a['dice']['std']:.4f}  (n={a['auc']['n']})",
                  flush=True)


def run(seeds: Sequence[int] = (0, 1, 2, 3, 4), skip: Sequence[str] = (),
        root_dir: str = ".", device: DeviceLike = None):
    """Train every (config, seed) of MODELS that has a cell left after
    `skip`, evaluate every missing entry, aggregate; returns the results
    dict."""
    device = resolve_device(device)
    res = load_results(root_dir, SEED_REPLICATION)
    # training first: the expensive assets exist even if evaluation stops
    tokens = {(config, seed): ensure_trained(config, seed, root_dir, device)
              for config in MODELS if kept_cells(config, skip)
              for seed in seeds}
    for _, config, cell, seed in work_list(res, seeds, skip):
        key = f"{cell}/seed{seed}"
        eval_args, em, sched = _load_eval_model(root_dir, tokens[(config, seed)],
                                                device=device)
        eval_args.update(PROTOCOLS[cell])
        summary = anomalous_metric_calculation(args=eval_args,
                                               root_dir=root_dir, em=em,
                                               sched=sched, device=device)
        res[key] = {m: summary[m] for m in METRICS}
        save_results(root_dir, SEED_REPLICATION, res)
        print(f"=== {key}: AUC {summary['auc']:.4f} "
              f"Dice {summary['dice']:.4f}", flush=True)
    aggregate(res, seeds)
    save_results(root_dir, SEED_REPLICATION, res)
    return res


def main(argv=None, device: DeviceLike = None):
    p = argparse.ArgumentParser(
        prog="python -m anoddpm_torch.campaigns.seed_replication")
    p.add_argument("seeds", nargs="*", type=int)
    p.add_argument("--skip", default="",
                   help="comma-separated substrings of cells to leave out")
    p.add_argument("--root", default=".")
    ns = p.parse_args(sys.argv[1:] if argv is None else argv)
    return run(ns.seeds or [0, 1, 2, 3, 4],
               [s for s in ns.skip.split(",") if s], ns.root, device=device)


if __name__ == "__main__":
    main()
