"""Detection quality across trained models and samplers:
``python -m anoddpm_torch.campaigns.model_size_quality <token> [<token>...]
[--root DIR]``.

Counterpart of `scripts/model_size_quality.py`: each token under DDPM-200,
DDIM-25 and DDIM-15 at eta = 1; AUC, Dice, SSIM and IoU per
``{token}/{protocol}``, printed after each and written to
metrics/torch_model_size_quality.json under DIR.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, Sequence

from ..detect import _load_eval_model, anomalous_metric_calculation
from ..device import DeviceLike

PROTOCOLS = [
    ("ddpm200", {"sampler": "ddpm"}),
    ("ddim25_eta1", {"sampler": "ddim", "ddim_steps": 25, "ddim_eta": 1.0}),
    ("ddim15_eta1", {"sampler": "ddim", "ddim_steps": 15, "ddim_eta": 1.0}),
]
SHOWN = ("auc", "dice", "ssim", "iou")
OUT = "metrics/torch_model_size_quality.json"


def run(tokens: Sequence[str], root_dir: str = ".",
        device: DeviceLike = None) -> Dict[str, Dict[str, float]]:
    results = {}
    for token in tokens:
        args, em, sched = _load_eval_model(root_dir, token, device=device)
        for name, overrides in PROTOCOLS:
            args.update(overrides)
            r = anomalous_metric_calculation(args=args, root_dir=root_dir,
                                             em=em, sched=sched, device=device)
            results[f"{token}/{name}"] = {m: round(r[m], 4) for m in SHOWN}
            print(json.dumps(results, indent=1), flush=True)
    path = os.path.join(root_dir, OUT)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(results, f, indent=1)
    return results


def main(argv=None, device: DeviceLike = None):
    p = argparse.ArgumentParser(
        prog="python -m anoddpm_torch.campaigns.model_size_quality")
    p.add_argument("tokens", nargs="+")
    p.add_argument("--root", default=".")
    ns = p.parse_args(sys.argv[1:] if argv is None else argv)
    return run(ns.tokens, ns.root, device)


if __name__ == "__main__":
    main()
