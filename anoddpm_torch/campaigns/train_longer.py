"""The training-length probe of the base-64 s2d-2 model:
``python -m anoddpm_torch.campaigns.train_longer <seed> [epochs]
[--root DIR]`` (1800 epochs by default).

Counterpart of `scripts/train_longer.py`.  It extends the trained seed
``256syn64s2d_s{seed}`` (600 epochs; trained by
`seed_replication.ensure_trained` when absent) to EPOCHS under the token
``256syn64s2dL{epochs}_s{seed}``, so that only the extension is paid for:

1. copy the source's model tree to the target only when the target is
   absent;
2. gate on the epoch count the target's params-final records
   (`_stages.train_gate`: the copy makes the file exist long before the
   extension has trained);
3. train with 8 steps per dispatch, from the target's newest periodic
   checkpoint when there is one (RESUME_RECENT), else from the copied
   params-final (RESUME_FINAL);
4. score the extended model under DDIM-25 and DDIM-15 at eta = 1 and
   DDPM-200, one entry ``s2dL{epochs}_{cell}/seed{seed}`` (AUC, Dice,
   SSIM, IoU) at a time in ``results/torch_train_longer.json`` under DIR;
   a finished entry is skipped.
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys
import time
from typing import Dict

from ..checkpoint import _args_dir
from ..device import DeviceLike, resolve_device
from ..train import train
from ._results import TRAIN_LONGER, load_results, save_results
from ._stages import score, train_gate
from .seed_replication import ensure_trained, train_args_for

CONFIG = "256syn64s2d"
EPOCHS = 1800
PROTOCOLS = {
    "ddim25_eta1": {"sampler": "ddim", "ddim_steps": 25, "ddim_eta": 1.0},
    "ddim15_eta1": {"sampler": "ddim", "ddim_steps": 15, "ddim_eta": 1.0},
    "ddpm200": {"sampler": "ddpm"},
}
METRICS = ("auc", "dice", "ssim", "iou")
SUBSTEPS = 8


def target_token(seed: int, epochs: int = EPOCHS) -> str:
    # the epoch target is part of the token, so that extensions of
    # different lengths never share checkpoints
    return f"{CONFIG}L{epochs}_s{seed}"


def result_key(cell: str, seed: int, epochs: int = EPOCHS) -> str:
    return f"s2dL{epochs}_{cell}/seed{seed}"


def extend(seed: int, epochs: int = EPOCHS, root_dir: str = ".",
           device: DeviceLike = None) -> str:
    """Train the target token to `epochs` unless it records them; its
    token."""
    token = target_token(seed, epochs)
    dst = _args_dir(root_dir, token)
    if not os.path.exists(dst):
        src = ensure_trained(CONFIG, seed, root_dir, device)
        shutil.copytree(_args_dir(root_dir, src), dst)
    _, needed, resume = train_gate(root_dir, token, epochs)
    if not needed:
        return token
    args = train_args_for(CONFIG, seed, root_dir)
    args["train_substeps"] = SUBSTEPS
    args["EPOCHS"] = epochs
    args["arg_num"] = token
    print(f"=== extending {CONFIG}_s{seed} -> {token} ({epochs} epochs, "
          f"{resume})", flush=True)
    t0 = time.time()
    train(args, root_dir=root_dir, resume=resume, device=device)
    print(f"=== {token} trained in {time.time() - t0:.1f} s", flush=True)
    return token


def run(seed: int, epochs: int = EPOCHS, root_dir: str = ".",
        device: DeviceLike = None) -> Dict[str, Dict]:
    """Extend, then score every protocol not yet in the results."""
    device = resolve_device(device)
    res = load_results(root_dir, TRAIN_LONGER)
    token = extend(seed, epochs, root_dir, device)
    for cell, proto in PROTOCOLS.items():
        key = result_key(cell, seed, epochs)
        if key in res:
            continue
        res[key] = score(root_dir, token, proto, METRICS, device)
        save_results(root_dir, TRAIN_LONGER, res)
        print(f"=== {key}: AUC {res[key]['auc']:.4f} "
              f"Dice {res[key]['dice']:.4f}", flush=True)
    return res


def main(argv=None, device: DeviceLike = None):
    p = argparse.ArgumentParser(
        prog="python -m anoddpm_torch.campaigns.train_longer")
    p.add_argument("seed", type=int)
    p.add_argument("epochs", nargs="?", type=int, default=EPOCHS)
    p.add_argument("--root", default=".")
    ns = p.parse_args(sys.argv[1:] if argv is None else argv)
    return run(ns.seed, ns.epochs, ns.root, device)


if __name__ == "__main__":
    main()
