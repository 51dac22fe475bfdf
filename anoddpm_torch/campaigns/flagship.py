"""The flagship quality campaign:
``python -m anoddpm_torch.campaigns.flagship [epochs] [--protocols=a,b]
[--skip-testing] [--skip-figures] [--root DIR] [--token T] [--substeps S]``.

Counterpart of `scripts/flagship_campaign.py`.  It trains
``configs/args{token}.json`` (args256syn128 by default: 256^2, base 128,
attention "16,8", T 1000, simplex noise, sample_distance 800) with the port
and produces its quality evidence in four stages, each skipped when its
result is already in ``results/torch_flagship_quality.json`` under DIR:

1. train, gated on the epoch count that params-final records: from the
   newest periodic checkpoint when one exists (RESUME_RECENT), else from
   params-final when it records fewer epochs than the target
   (RESUME_FINAL), else fresh; `skip_test_eval` on and `train_substeps` S
   steps per dispatch;
2. detection on the anomalous set with the EMA weights, DDPM lambda = 200
   and DDIM-15 at eta = 1 (``flagship_{cell}@{epochs}``; writes
   metrics/args{token}.csv);
3. the test-set suite (16 images, batch 4, VLB at the batch mean, no
   videos; ``testing@{epochs}``, metrics/args{token}-test.json);
4. the figures: `figures.ano_outputs` and `figures.masked_comparison` at
   lambda = 250 under final-outputs/ (``figures_done``).

Everything is read and written under DIR (the working directory by
default): configs/, model/, metrics/, results/, final-outputs/.  The DDPM
result is printed against the JAX package's band (`band`).  It runs on the
card, and no stage's error is caught.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import sys
import time
from typing import Any, Dict, Iterable, Optional, Tuple

from .. import figures
from ..config import load_args
from ..data.datasets import dataset_from_args
from ..data.pipeline import batch_iterator
from ..detect import _load_eval_model, anomalous_metric_calculation
from ..device import DeviceLike, resolve_device
from ..evaluation import testing
from ..ops.noise import sampler_from_args
from ..train import train
from . import band
from ._results import FLAGSHIP, load_results, save_results

TOKEN = "256syn128"
PROTOCOLS = {
    "ddpm200": {"sampler": "ddpm"},
    "ddim15_eta1": {"sampler": "ddim", "ddim_steps": 15, "ddim_eta": 1.0},
}
METRICS = ("auc", "dice", "ssim", "iou", "precision", "recall", "fpr")
SUBSTEPS = 4
TEST_IMAGES = 16


def train_gate(root_dir: str, token: str, target: int
               ) -> Tuple[int, bool, Optional[str]]:
    """(epochs params-final records, whether to train, the resume mode)."""
    base = os.path.join(root_dir, "model", f"diff-params-ARGS={token}")
    meta_path = os.path.join(base, "params-final", "meta.json")
    recorded = 0
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            recorded = int(json.load(f).get("n_epoch", 0))
    if recorded >= target:
        return recorded, False, None
    ckpt_dir = os.path.join(base, "checkpoint")
    if os.path.isdir(ckpt_dir) and os.listdir(ckpt_dir):
        return recorded, True, "RESUME_RECENT"
    return recorded, True, "RESUME_FINAL" if recorded > 0 else None


def run(root_dir: str = ".", token: str = TOKEN, epochs: Optional[int] = None,
        protocols: Optional[Iterable[str]] = None, skip_testing: bool = False,
        skip_figures: bool = False, substeps: int = SUBSTEPS,
        test_images: int = TEST_IMAGES,
        device: DeviceLike = None) -> Dict[str, Any]:
    """The four stages under `root_dir`; returns the results dict."""
    device = resolve_device(device)
    protos = {k: v for k, v in PROTOCOLS.items()
              if protocols is None or k in protocols}
    res = load_results(root_dir, FLAGSHIP)
    args = copy.deepcopy(load_args(token,
                                   config_dir=os.path.join(root_dir, "configs")))
    if epochs:
        args["EPOCHS"] = epochs
    target = int(args["EPOCHS"])
    args["train_substeps"] = substeps
    # the campaign runs its own test-set suite below
    args["skip_test_eval"] = True
    walls = {}

    # 1. train, gated on the epoch count params-final records
    recorded, needed, resume = train_gate(root_dir, token, target)
    if needed:
        print(f"=== training args{token} epochs {recorded}..{target} "
              f"(resume: {resume})", flush=True)
        t0 = time.time()
        train(args, root_dir=root_dir, resume=resume, device=device)
        walls["train"] = res[f"train_seconds@{target}"] = time.time() - t0
        res[f"train_slice@{target}"] = [recorded, target]
        res["train_epochs"] = target
        save_results(root_dir, FLAGSHIP, res)

    # 2. detection under each protocol, keyed by the epoch target
    for cell, proto in protos.items():
        key = f"flagship_{cell}@{target}"
        if key in res or (target == 600 and f"flagship_{cell}" in res):
            continue
        eval_args, em, sched = _load_eval_model(root_dir, token, device=device)
        eval_args.update(proto)
        t0 = time.time()
        summary = anomalous_metric_calculation(args=eval_args,
                                               root_dir=root_dir, em=em,
                                               sched=sched, device=device)
        res[key] = {m: summary[m] for m in METRICS}
        walls[cell] = res[key]["eval_seconds"] = time.time() - t0
        save_results(root_dir, FLAGSHIP, res)
        print(f"=== {key}: AUC {summary['auc']:.4f} "
              f"Dice {summary['dice']:.4f}", flush=True)
        if cell == "ddpm200":
            print("=== " + band.verdict(res[key]), flush=True)

    # 3. the test-set suite (videos off: numbers, not artifacts)
    if not skip_testing and f"testing@{target}" not in res:
        eval_args, em, sched = _load_eval_model(root_dir, token, device=device)
        eval_args["vlb_batch_mean"] = True
        it = batch_iterator(dataset_from_args(root_dir, eval_args, train=False),
                            4, shuffle=True, seed=2)
        t0 = time.time()
        out = testing(it, em, sched, eval_args,
                      noise_sampler=sampler_from_args(eval_args),
                      root_dir=root_dir, n_images=test_images,
                      save_videos=False)
        res[f"testing@{target}"] = {k: round(float(v), 5)
                                    for k, v in out.items()}
        walls["testing"] = res[f"testing@{target}"]["eval_seconds"] = \
            time.time() - t0
        save_results(root_dir, FLAGSHIP, res)

    # 4. the figures at the flagship resolution
    if not skip_figures and "figures_done" not in res:
        eval_args, em, sched = _load_eval_model(root_dir, token, device=device)
        t0 = time.time()
        figures.ano_outputs(eval_args, em, sched, root_dir=root_dir,
                            n_attempts=1, rows=2, t_distance=250)
        figures.masked_comparison(eval_args, em, sched, root_dir=root_dir,
                                  t_distance=250)
        walls["figures"] = time.time() - t0
        res["figures_done"] = True
        save_results(root_dir, FLAGSHIP, res)

    print("stage walls (s): " + (", ".join(f"{k} {v:.1f}"
                                           for k, v in walls.items())
                                 or "every stage skipped"), flush=True)
    print(json.dumps({k: v for k, v in res.items()
                      if k.startswith("flagship_")}, indent=1))
    return res


def parse_argv(argv) -> Dict[str, Any]:
    p = argparse.ArgumentParser(prog="python -m anoddpm_torch.campaigns.flagship")
    p.add_argument("epochs", nargs="?", type=int, default=None)
    p.add_argument("--protocols", default=None,
                   help=f"comma-separated subset of {sorted(PROTOCOLS)}")
    p.add_argument("--skip-testing", action="store_true")
    p.add_argument("--skip-figures", action="store_true")
    p.add_argument("--root", default=".")
    p.add_argument("--token", default=TOKEN)
    p.add_argument("--substeps", type=int, default=SUBSTEPS)
    ns = p.parse_args(argv)
    protocols = None
    if ns.protocols is not None:
        protocols = ns.protocols.split(",")
        unknown = [n for n in protocols if n not in PROTOCOLS]
        if unknown:
            raise SystemExit(f"unknown protocol(s) {unknown}; "
                             f"known: {sorted(PROTOCOLS)}")
    return {"root_dir": ns.root, "token": ns.token, "epochs": ns.epochs,
            "protocols": protocols, "skip_testing": ns.skip_testing,
            "skip_figures": ns.skip_figures, "substeps": ns.substeps}


def main(argv=None, device: DeviceLike = None) -> Dict[str, Any]:
    return run(**parse_argv(sys.argv[1:] if argv is None else argv),
               device=device)


if __name__ == "__main__":
    main()
