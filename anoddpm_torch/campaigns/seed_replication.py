"""Seed-replicated quality evidence:
``python -m anoddpm_torch.campaigns.seed_replication [seeds...]
[--skip=a,b] [--norm-order kernel|flax] [--rng torch|jax] [--own-file]
[--skip-test-eval] [--root DIR]`` (seeds 0 1 2 3 4 by default).

Counterpart of `scripts/seed_replication.py`.  Each model cell trains
fresh seeds end to end through `train.train` (8 steps per dispatch, token
``{config}_s{seed}``); then every protocol cell is evaluated on every seed
through the detection path, cheapest first (DDIM by its step count, DDPM
at 200), and the aggregates are taken over every seed in the file.
Results go to ``results/torch_seed_replication.json`` under DIR, one entry
``{cell}/seed{n}`` at a time (a rerun skips finished entries).  `--skip`
leaves out the cells whose names contain one of its substrings.

`--norm-order flax` trains the seeds in the JAX package's own norm order
as its seed band was trained (`NORM_ORDERS`: `norm_impl` "flax",
`bf16_norm` and `pallas_norm` off), under their own tokens
``{config}_s{seed}_flaxorder``, and writes their entries to
``results/torch_f3_flax_order_seeds{seeds}.json``, one file per process,
so that processes of different seeds can run at once.  `--own-file` does
the same in the default order: the entries go to
``results/torch_seed_replication_seeds{seeds}.json``
(`campaigns.band` reads them beside the shared file).

`--rng jax` trains the seeds on the JAX package's own draws (`rng: "jax"`:
flax's init, the trainer's and the detector's threefry keys) in the flax
order, the JAX five's numerics (`NORM_ORDERS["jax_rng"]`; the kernel order
is refused), under the tokens ``{config}_s{seed}_jaxrng``, and writes
their entries to a file per process and config (`JAX_RNG_FILES`:
``results/torch_f3_jax_rng_seeds{seeds}.json`` for 256syn64s2d,
``results/torch_jax_rng_256syn128_seeds{seeds}.json`` for 256syn128), so a
run on the JAX streams keeps the cells of one config (`--skip=paper128`,
or `--skip=s2d64,_diffuse`): seed S of the port is then seed S of the JAX
package (`campaigns.band --jax-rng [--config C]` pairs them).
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
# The norm orders a seed can be trained in: the config's own ("kernel": the
# port's default, K2 in the TPU kernel's order), or the order the JAX
# package's seed band was trained in (flax's composition at every site, with
# the fp32 norm gradient of before the `bf16_norm` flip), each with the
# suffix of its tokens.
NORM_ORDERS = {"kernel": ({}, ""),
               "flax": ({"norm_impl": "flax", "bf16_norm": False,
                         "pallas_norm": False}, "_flaxorder")}
# the flax order on the JAX package's own random streams: the recipe that
# pairs seed S of the port with seed S of the JAX package
NORM_ORDERS["jax_rng"] = ({**NORM_ORDERS["flax"][0], "rng": "jax"}, "_jaxrng")
FLAX_ORDER_RESULTS = "results/torch_f3_flax_order_seeds{}.json"
JAX_RNG_RESULTS = "results/torch_f3_jax_rng_seeds{}.json"
JAX_RNG_FILES = {"256syn64s2d": JAX_RNG_RESULTS,
                 "256syn128": "results/torch_jax_rng_256syn128_seeds{}.json"}
OWN_FILE_RESULTS = "results/torch_seed_replication_seeds{}.json"


def results_name(seeds: Sequence[int], norm_order: str = "kernel",
                 own_file: bool = False, config: str = "256syn64s2d") -> str:
    """The results file of a run of `seeds` in `norm_order`: the shared
    file of the default order, unless `own_file` asks for one per process
    (always so in the flax order and on the JAX streams, where each config
    has its own)."""
    tag = "".join(str(s) for s in seeds)
    if norm_order == "jax_rng":
        return JAX_RNG_FILES[config].format(tag)
    if norm_order != "kernel":
        return FLAX_ORDER_RESULTS.format(tag)
    return OWN_FILE_RESULTS.format(tag) if own_file else SEED_REPLICATION


def train_args_for(config: str, seed: int, root_dir: str = ".",
                   norm_order: str = "kernel"):
    """configs/args{config}.json under `root_dir` with the seed, 8 substeps,
    the keys of `norm_order` and the token {config}_s{seed} (with the
    order's suffix)."""
    norm, suffix = NORM_ORDERS[norm_order]
    args = copy.deepcopy(load_args(config,
                                   config_dir=os.path.join(root_dir, "configs")))
    args.update(norm)
    args["seed"] = seed
    args["train_substeps"] = SUBSTEPS
    args["arg_num"] = f"{config}_s{seed}{suffix}"
    return args


def ensure_trained(config: str, seed: int, root_dir: str = ".",
                   device: DeviceLike = None, norm_order: str = "kernel",
                   skip_test_eval: bool = False) -> str:
    """Train {config}_s{seed} (in `norm_order`; without the test-set suite
    after it if `skip_test_eval`) unless its params-final exists; its
    token."""
    args = train_args_for(config, seed, root_dir, norm_order)
    if skip_test_eval:
        args["skip_test_eval"] = True
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
        root_dir: str = ".", device: DeviceLike = None,
        norm_order: str = "kernel", own_file: bool = False,
        skip_test_eval: bool = False):
    """Train every (config, seed) of MODELS that has a cell left after
    `skip`, in `norm_order` (`skip_test_eval`: without the test-set suite,
    which reads the trained weights and changes none), evaluate every
    missing entry, aggregate; returns the results dict (`results_name`
    says which file)."""
    device = resolve_device(device)
    configs = [config for config in MODELS if kept_cells(config, skip)]
    if norm_order == "jax_rng" and len(configs) != 1:
        raise ValueError("a run on the JAX streams keeps the cells of one "
                         f"config (--skip), not {configs}")
    name = results_name(seeds, norm_order, own_file, *configs[:1])
    res = load_results(root_dir, name)
    # training first: the expensive assets exist even if evaluation stops
    extra = {"skip_test_eval": True} if skip_test_eval else {}
    tokens = {(config, seed): ensure_trained(config, seed, root_dir, device,
                                             norm_order, **extra)
              for config in configs for seed in seeds}
    for _, config, cell, seed in work_list(res, seeds, skip):
        key = f"{cell}/seed{seed}"
        eval_args, em, sched = _load_eval_model(root_dir, tokens[(config, seed)],
                                                device=device)
        eval_args.update(PROTOCOLS[cell])
        summary = anomalous_metric_calculation(args=eval_args,
                                               root_dir=root_dir, em=em,
                                               sched=sched, device=device)
        res[key] = {m: summary[m] for m in METRICS}
        save_results(root_dir, name, res)
        print(f"=== {key}: AUC {summary['auc']:.4f} "
              f"Dice {summary['dice']:.4f}", flush=True)
    aggregate(res, seeds)
    save_results(root_dir, name, res)
    return res


def main(argv=None, device: DeviceLike = None):
    p = argparse.ArgumentParser(
        prog="python -m anoddpm_torch.campaigns.seed_replication")
    p.add_argument("seeds", nargs="*", type=int)
    p.add_argument("--skip", default="",
                   help="comma-separated substrings of cells to leave out")
    p.add_argument("--norm-order", choices=("flax", "kernel"),
                   default=None, help="kernel (the default) or flax")
    p.add_argument("--rng", choices=("torch", "jax"), default="torch",
                   help="jax: train and score on the JAX package's draws, "
                        "in the flax order")
    p.add_argument("--own-file", action="store_true",
                   help="write this process's entries to a file of its own")
    p.add_argument("--skip-test-eval", action="store_true",
                   help="train without the test-set suite after training")
    p.add_argument("--root", default=".")
    ns = p.parse_args(sys.argv[1:] if argv is None else argv)
    norm_order = ns.norm_order or "kernel"
    if ns.rng == "jax":
        if ns.norm_order == "kernel":
            p.error("the JAX-stream seeds train in the JAX package's own "
                    "norm order (--norm-order flax)")
        norm_order = "jax_rng"
    return run(ns.seeds or [0, 1, 2, 3, 4],
               [s for s in ns.skip.split(",") if s], ns.root, device=device,
               norm_order=norm_order, own_file=ns.own_file,
               skip_test_eval=ns.skip_test_eval)


if __name__ == "__main__":
    main()
