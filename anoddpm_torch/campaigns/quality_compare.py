"""DDPM full chain against DDIM-strided detection on one trained token:
``python -m anoddpm_torch.campaigns.quality_compare <ARG_NUM> [ddim_steps...]
[--root DIR]`` (DDIM-25 by default).

Counterpart of `scripts/quality_compare.py`: the headline protocol with
the token's own sampler, then DDIM at each step count (eta from the
token's args), printed as AUC, Dice, SSIM and IoU per protocol.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, Sequence

from ..detect import _load_eval_model, anomalous_metric_calculation
from ..device import DeviceLike

SHOWN = ("auc", "dice", "ssim", "iou")


def run(token: str, step_counts: Sequence[int] = (25,), root_dir: str = ".",
        device: DeviceLike = None) -> Dict[str, Dict[str, float]]:
    """{"ddpm_full": summary, "ddim_{s}": summary, ...}."""
    args, em, sched = _load_eval_model(root_dir, token, device=device)
    results = {"ddpm_full": anomalous_metric_calculation(
        args=args, root_dir=root_dir, em=em, sched=sched, device=device)}
    for s in step_counts:
        args["sampler"] = "ddim"
        args["ddim_steps"] = s
        results[f"ddim_{s}"] = anomalous_metric_calculation(
            args=args, root_dir=root_dir, em=em, sched=sched, device=device)
    print(json.dumps({k: {m: round(v[m], 4) for m in SHOWN}
                      for k, v in results.items()}, indent=1))
    return results


def main(argv=None, device: DeviceLike = None):
    p = argparse.ArgumentParser(
        prog="python -m anoddpm_torch.campaigns.quality_compare")
    p.add_argument("token")
    p.add_argument("ddim_steps", nargs="*", type=int)
    p.add_argument("--root", default=".")
    ns = p.parse_args(sys.argv[1:] if argv is None else argv)
    return run(ns.token, ns.ddim_steps or [25], ns.root, device)


if __name__ == "__main__":
    main()
