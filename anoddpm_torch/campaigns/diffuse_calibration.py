"""The diffuse-lesion severity calibration:
``python -m anoddpm_torch.campaigns.diffuse_calibration [severities...]
[--root DIR] [--token T]`` (severities 1.0 1.5 2.0 2.5 by default).

Counterpart of `scripts/diffuse_calibration.py`.  On one trained seed
(token ``256syn64s2d_s1``) each severity of the diffuse lesion family is
scored under DDIM-15 at eta = 1; AUC, Dice, SSIM and IoU go under
``ddim15_eta1_diffuse_sev{sev:g}`` in
``results/torch_diffuse_calibration.json`` under DIR, written as each
severity finishes.  A severity already in the file is skipped.
"""

from __future__ import annotations

import argparse
import sys
from typing import Dict, Sequence

from ..device import DeviceLike, resolve_device
from ._results import DIFFUSE_CALIBRATION, load_results, save_results
from ._stages import score

TOKEN = "256syn64s2d_s1"
SEVERITIES = (1.0, 1.5, 2.0, 2.5)
METRICS = ("auc", "dice", "ssim", "iou")
PROTOCOL = {"sampler": "ddim", "ddim_steps": 15, "ddim_eta": 1.0,
            "lesion_kind": "diffuse"}


def key(sev: float) -> str:
    return f"ddim15_eta1_diffuse_sev{sev:g}"


def run(severities: Sequence[float] = SEVERITIES, root_dir: str = ".",
        token: str = TOKEN, device: DeviceLike = None) -> Dict[str, Dict]:
    """Score every severity not yet in the results; returns the results."""
    device = resolve_device(device)
    res = load_results(root_dir, DIFFUSE_CALIBRATION)
    for sev in severities:
        if key(sev) in res:
            continue
        entry = score(root_dir, token, {**PROTOCOL, "lesion_severity": sev},
                      METRICS, device)
        res[key(sev)] = entry
        save_results(root_dir, DIFFUSE_CALIBRATION, res)
        print(f"=== severity {sev:g}: AUC {entry['auc']:.4f} "
              f"Dice {entry['dice']:.4f}", flush=True)
    return res


def main(argv=None, device: DeviceLike = None):
    p = argparse.ArgumentParser(
        prog="python -m anoddpm_torch.campaigns.diffuse_calibration")
    p.add_argument("severities", nargs="*", type=float)
    p.add_argument("--root", default=".")
    p.add_argument("--token", default=TOKEN)
    ns = p.parse_args(sys.argv[1:] if argv is None else argv)
    return run(ns.severities or SEVERITIES, ns.root, ns.token, device)


if __name__ == "__main__":
    main()
