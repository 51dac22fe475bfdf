"""Dense per-lambda curves over the whole anomalous set:
``python -m anoddpm_torch.campaigns.dense_sweep [step] [vols] [--root DIR]``
(step 25 over 22 volumes by default).

Counterpart of `scripts/dense_sweep_campaign.py`.  It trains the base-64
s2d-2 model (token ``256syn64s2d``, its config's seed 0 and 600 epochs,
the test-set suite off) unless its params-final records the config's
epochs (`_stages.train_gate`): from the newest periodic checkpoint when
there is one, else from params-final when it exists, else fresh; then drives
`detect.graph_data` over every `step`-th lambda in [0, T) on `vols`
volumes, which writes metrics/ARGS=256syn64s2d/{volume}.csv and the pooled
metrics/args256syn64s2d-lambda.csv under DIR.  The walls, the grid and the
CSV names go to ``results/torch_dense_sweep_full.json`` under the JAX
script's keys.  A sweep whose step and volume count the file already
records is not run again, unless this run trained the model.

``python -m anoddpm_torch.campaigns.dense_sweep --replot DIR`` draws, on
the CPU and with no model, the plots a sweep on a machine without
matplotlib left out, from its CSVs under DIR (DIR/ARGS={token}/*.csv and
DIR/args{token}-lambda.csv): each volume's PNG beside its CSV and the
pooled DIR/args{token}-dice-lambda.png, with the plotting functions
`graph_data` uses.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import sys
import time
from typing import Any, Dict, List

from .. import graphs
from ..config import load_args
from ..detect import _per_volume_lambda_plot, graph_data
from ..device import DeviceLike, resolve_device
from ..train import train
from ._results import DENSE_SWEEP, load_results, save_results
from ._stages import train_gate

TOKEN = "256syn64s2d"
STEP = 25
VOLUMES = 22


def run(step: int = STEP, vols: int = VOLUMES, root_dir: str = ".",
        token: str = TOKEN, device: DeviceLike = None) -> Dict[str, Any]:
    device = resolve_device(device)
    res = load_results(root_dir, DENSE_SWEEP)
    args = copy.deepcopy(load_args(
        token, config_dir=os.path.join(root_dir, "configs")))
    args["skip_test_eval"] = True
    _, needed, resume = train_gate(root_dir, token, int(args["EPOCHS"]))
    if needed:
        print(f"=== training {token} ({args['EPOCHS']} epochs, resume: "
              f"{resume})", flush=True)
        t0 = time.time()
        train(args, root_dir=root_dir, resume=resume, device=device)
        res["train_seconds"] = time.time() - t0
        res["train_epochs"] = int(args["EPOCHS"])
        # a sweep recorded before belongs to another model: sweep again
        for k in ("lambda_step", "volumes"):
            res.pop(k, None)
        save_results(root_dir, DENSE_SWEEP, res)

    if (res.get("lambda_step"), res.get("volumes")) != (step, vols):
        t0 = time.time()
        graph_data(root_dir=root_dir, token=token, dense=True,
                   lambda_step=step, max_volumes=vols, device=device)
        res["sweep_seconds"] = time.time() - t0
        res["lambda_step"] = step
        res["volumes"] = vols
        csv_dir = os.path.join(root_dir, "metrics", f"ARGS={token}")
        res["csv_files"] = sorted(f for f in os.listdir(csv_dir)
                                  if f.endswith(".csv"))
        save_results(root_dir, DENSE_SWEEP, res)
    print(json.dumps(res, indent=1))
    return res


# the per-volume CSV's columns of the curves `_per_volume_lambda_plot` draws
PLOTTED = {"dice": "Dice", "iou": "IOU", "precision": "Precision",
           "recall": "Recall"}


def replot(csv_root: str, token: str = TOKEN) -> List[str]:
    """The per-volume and pooled plots from the CSVs under `csv_root`;
    returns the PNG paths."""
    vol_dir = os.path.join(csv_root, f"ARGS={token}")
    written = []
    for name in sorted(f for f in os.listdir(vol_dir) if f.endswith(".csv")):
        cols = graphs._read_columns(os.path.join(vol_dir, name))
        lambdas = [int(t) for t in cols["timestep"]]
        curves = {k: graphs._as_number(cols[c]) for k, c in PLOTTED.items()}
        path = os.path.join(vol_dir, name[:-4] + ".png")
        _per_volume_lambda_plot(lambdas, curves, path)
        written.append(path)
    path = os.path.join(csv_root, f"args{token}-dice-lambda.png")
    graphs.graph_dice_comparison(
        [os.path.join(csv_root, f"args{token}-lambda.csv")], [f"args{token}"],
        path)
    return written + [path]


def main(argv=None, device: DeviceLike = None):
    p = argparse.ArgumentParser(
        prog="python -m anoddpm_torch.campaigns.dense_sweep")
    p.add_argument("step", nargs="?", type=int, default=STEP)
    p.add_argument("vols", nargs="?", type=int, default=VOLUMES)
    p.add_argument("--root", default=".")
    p.add_argument("--replot", metavar="DIR", default=None,
                   help="draw the plots from a sweep's CSVs under DIR")
    ns = p.parse_args(sys.argv[1:] if argv is None else argv)
    if ns.replot is not None:
        return replot(ns.replot)
    return run(ns.step, ns.vols, ns.root, device=device)


if __name__ == "__main__":
    main()
