"""The norm paths A/B on the card:
``python -m anoddpm_torch.campaigns.bf16_norm_ab [--quality [S ...]]
[--root DIR]``.

Counterpart of `scripts/bf16_norm_ab.py`, over the port's three norm paths
(`PATHS`): "kernel" (K2 at every norm+SiLU site, K2b under autograd),
"flax_fp32" and "flax_bf16" (`norm_impl="flax"` with `bf16_norm` off and
on: the JAX package's own composition).  It times, for each path,

  1. a train step at the paper config (256^2, base 128, batch 8, 4
     substeps per `make_multi_step` call; `bench.train_probe`), and
  2. DDIM-25 eta = 1 inference at the headline config (base 64, s2d 2,
     batch 32, lambda 250; `bench.run_bench`, median of 3),

into ``results/torch_bf16_norm_ab.json`` under DIR (a rerun skips the
entries it has).  `--quality S ...` (seed 0 when none is given) trains
args256syn64s2d with `norm_impl="flax"`, `bf16_norm=True` and 8 substeps
through `train.train` (token ``256syn64s2d_bf16n_s{S}``), scores DDIM-25
eta = 1 into ``results/torch_seed_replication.json`` as
``s2d64_ddim25_eta1_bf16norm/seed{S}``, and aggregates that cell with
`seed_replication.aggregate`.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Dict, Sequence

from ..bench import card_info, run_bench, train_probe
from ..device import DeviceLike, resolve_device
from ..train import train
from . import _stages, seed_replication
from ._results import SEED_REPLICATION, load_results, save_results

RESULTS = "results/torch_bf16_norm_ab.json"
PATHS = {"kernel": dict(norm_impl="kernel"),
         "flax_fp32": dict(norm_impl="flax", bf16_norm=False),
         "flax_bf16": dict(norm_impl="flax", bf16_norm=True)}
CELL = "s2d64_ddim25_eta1_bf16norm"
PROTOCOL = {"sampler": "ddim", "ddim_steps": 25, "ddim_eta": 1.0}
CONFIG = "256syn64s2d"


def time_train_step(norm: Dict, batch: int = 8, img: int = 256,
                    base: int = 128, substeps: int = 4, repeats: int = 5,
                    device: DeviceLike = None) -> Dict:
    p = train_probe(batch, img, base, substeps, repeats, norm=norm,
                    device=device)
    return {k: p[k] for k in ("ms_per_step", "imgs_per_sec", "batch",
                              "substeps", "tflop_per_step",
                              "peak_memory_gib")}


def time_inference(norm: Dict, batch: int = 32, img: int = 256,
                   base: int = 64, s2d: int = 2, t_distance: int = 250,
                   ddim_steps: int = 25, repeats: int = 3,
                   device: DeviceLike = None) -> Dict:
    sps, spread = run_bench(batch, t_distance=t_distance, img=img,
                            base_channels=base, repeats=repeats,
                            ddim_steps=ddim_steps, ddim_eta=1.0,
                            space_to_depth=s2d, norm=norm, device=device)
    return {"slices_per_sec": sps, "sec_median": spread["sec_median"],
            "sec": spread["sec"], "batch": batch, "ddim_steps": ddim_steps}


def run_timings(root_dir: str = ".", device: DeviceLike = None,
                train_kw: Dict = None, infer_kw: Dict = None) -> Dict:
    """Each path's train and inference timing, skipping those in the file."""
    device = resolve_device(device)
    res = load_results(root_dir, RESULTS)
    res["card"] = card_info(device)
    for tag, norm in PATHS.items():
        for kind, fn, kw in (("train", time_train_step, train_kw),
                             ("infer", time_inference, infer_kw)):
            key = f"{kind}/{tag}"
            if key not in res:
                res[key] = fn(norm, device=device, **(kw or {}))
                print(f"{key}: {res[key]}", flush=True)
                save_results(root_dir, RESULTS, res)
    save_results(root_dir, RESULTS, res)
    return res


def quality_args(seed: int, root_dir: str = "."):
    """args256syn64s2d under `root_dir` as seed_replication trains it (8
    substeps), on the JAX package's bf16 norm path."""
    args = seed_replication.train_args_for(CONFIG, seed, root_dir)
    args["norm_impl"] = "flax"
    args["bf16_norm"] = True
    args["arg_num"] = f"{CONFIG}_bf16n_s{seed}"
    return args


def quality_cell(seed: int, root_dir: str = ".", device: DeviceLike = None):
    """Train (unless its params-final exists) and score one seed."""
    args = quality_args(seed, root_dir)
    token = args["arg_num"]
    final = os.path.join(root_dir, "model", f"diff-params-ARGS={token}",
                         "params-final", "payload.msgpack")
    if not os.path.exists(final):
        print(f"=== training {token} ({args['EPOCHS']} epochs)", flush=True)
        train(args, root_dir=root_dir, device=device)
    scores = _stages.score(root_dir, token, PROTOCOL, seed_replication.METRICS,
                           device)
    res = load_results(root_dir, SEED_REPLICATION)
    res[f"{CELL}/seed{seed}"] = scores
    seed_replication.aggregate(res, cells=[CELL])
    save_results(root_dir, SEED_REPLICATION, res)
    print(f"=== {CELL}/seed{seed}: AUC {scores['auc']:.4f} "
          f"Dice {scores['dice']:.4f}", flush=True)
    return scores


def main(argv=None, device: DeviceLike = None):
    p = argparse.ArgumentParser(prog="python -m anoddpm_torch.campaigns.bf16_norm_ab")
    p.add_argument("--quality", nargs="*", type=int, default=None)
    p.add_argument("--root", default=".")
    ns = p.parse_args(sys.argv[1:] if argv is None else argv)
    device = resolve_device(device)
    if ns.quality is None:
        return run_timings(ns.root, device)
    seeds: Sequence[int] = ns.quality or [0]
    return {s: quality_cell(s, ns.root, device) for s in seeds}


if __name__ == "__main__":
    main()
