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

``--rng jax`` trains and sweeps on the JAX package's own random streams
(config key `rng: "jax"`, the norm+SiLU sites in the JAX package's order,
`norm_impl: "flax"`, with the config's `bf16_norm`, as the JAX UNet takes
it), as token ``256syn64s2d_jaxrng``; its walls go to
``results/torch_dense_sweep_jaxrng/sweep.json`` and its CSVs are copied
beside it (``ARGS=256syn64s2d_jaxrng/*.csv`` and the pooled
``args256syn64s2d_jaxrng-lambda.csv``).  ``--paired`` then holds those
curves against the JAX package's sweep (``metrics/ARGS=256syn64s2d/`` and
``metrics/args256syn64s2d-lambda.csv``, which the port never writes) by
`paired_verdict` and writes ``results/torch_dense_sweep_jaxrng_paired.json``,
with the torch-stream sweep (``results/torch_dense_sweep/``) beside it.

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
import shutil
import sys
import time
from typing import Any, Dict, List, Mapping, Sequence, Tuple

import numpy as np
from scipy import stats

from .. import graphs
from ..config import load_args
from ..detect import _per_volume_lambda_plot, graph_data
from ..device import DeviceLike, resolve_device
from ..train import train
from ._results import (DENSE_SWEEP, DENSE_SWEEP_JAX_RNG,
                       DENSE_SWEEP_JAX_RNG_PAIRED, load_results, save_results)
from ._stages import train_gate
from .band import holm

TOKEN = "256syn64s2d"
STEP = 25
VOLUMES = 22
JAX_RNG_DIR = os.path.dirname(DENSE_SWEEP_JAX_RNG)
TORCH_STREAM_DIR = "results/torch_dense_sweep"


def sweep_args(root_dir: str = ".", token: str = TOKEN, rng: str = "torch"):
    """The config the sweep trains: configs/args{token}.json with the
    test-set suite off; under rng "jax" the JAX package's streams and norm
    order, as token {token}_jaxrng."""
    args = copy.deepcopy(load_args(
        token, config_dir=os.path.join(root_dir, "configs")))
    args["skip_test_eval"] = True
    if rng == "jax":
        args.update(rng="jax", norm_impl="flax", arg_num=f"{token}_jaxrng")
    return args


def run(step: int = STEP, vols: int = VOLUMES, root_dir: str = ".",
        token: str = TOKEN, device: DeviceLike = None,
        rng: str = "torch") -> Dict[str, Any]:
    device = resolve_device(device)
    results = DENSE_SWEEP if rng == "torch" else DENSE_SWEEP_JAX_RNG
    res = load_results(root_dir, results)
    args = sweep_args(root_dir, token, rng)
    token = args["arg_num"]
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
        save_results(root_dir, results, res)

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
        if rng == "jax":
            _copy_curves(root_dir, token)
        save_results(root_dir, results, res)
    print(json.dumps(res, indent=1))
    return res


def _copy_curves(root_dir: str, token: str) -> None:
    """The sweep's CSVs under metrics/ copied into JAX_RNG_DIR."""
    out = os.path.join(root_dir, JAX_RNG_DIR, f"ARGS={token}")
    os.makedirs(out, exist_ok=True)
    csv_dir = os.path.join(root_dir, "metrics", f"ARGS={token}")
    for name in os.listdir(csv_dir):
        if name.endswith(".csv"):
            shutil.copy(os.path.join(csv_dir, name), out)
    shutil.copy(os.path.join(root_dir, "metrics", f"args{token}-lambda.csv"),
                os.path.join(root_dir, JAX_RNG_DIR))


# --- the port's curves against the JAX package's ---------------------------

PEAK_STEPS = 1          # a peak within one grid step of the JAX package's
MEDIAN_ABS = 0.01       # the median over lambda of |pooled difference|
PEARSON_R = 0.95


def read_pooled(path: str) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
    """(lambdas, {"dice", "auc"}) of a pooled args{n}-lambda.csv."""
    cols = graphs._read_columns(path)
    return (np.array([int(float(t)) for t in cols["t"]]),
            {m: graphs._as_number(cols[m]) for m in ("dice", "auc")})


def read_volume_dice(csv_dir: str) -> Dict[str, np.ndarray]:
    """{volume: its Dice over the lambda grid} of a sweep's per-volume
    CSVs."""
    return {name[:-4]: graphs._as_number(
                graphs._read_columns(os.path.join(csv_dir, name))["Dice"])
            for name in sorted(os.listdir(csv_dir)) if name.endswith(".csv")}


def _curve(lambdas, port: np.ndarray, jax: np.ndarray) -> Dict[str, float]:
    """One pooled metric of the port against the JAX package's."""
    diff = np.abs(port - jax)
    return {"port_peak_lambda": int(lambdas[int(np.argmax(port))]),
            "port_peak": float(np.max(port)),
            "jax_peak_lambda": int(lambdas[int(np.argmax(jax))]),
            "jax_peak": float(np.max(jax)),
            "median_abs": float(np.median(diff)),
            "max_abs": float(np.max(diff)),
            "pearson_r": float(np.corrcoef(port, jax)[0, 1])}


def paired_verdict(lambdas: Sequence[int], port: Mapping[str, np.ndarray],
                   jax: Mapping[str, np.ndarray],
                   port_dice: Mapping[str, np.ndarray],
                   jax_dice: Mapping[str, np.ndarray],
                   step: int = STEP) -> Dict[str, Any]:
    """The rule written before the card run (PERF.md section 2).  P1: the
    lambda of the pooled Dice peak and of the pooled AUC peak.  "closed:
    the curve pairs" when both peaks lie within one grid step of the JAX
    package's, and for Dice and for AUC the median over lambda of |port -
    JAX| is at most .01 and Pearson's r over lambda at least .95;
    otherwise a paired t-test of the per-volume Dice at each lambda where
    the volumes' differences are not all equal, Holm at .05 across those
    lambdas: "a fault in the port" (Dice over the lambdas it rejects) if
    one rejects, else "open: the trajectories part"."""
    lambdas = np.asarray(lambdas)
    curves = {m: _curve(lambdas, port[m], jax[m]) for m in ("dice", "auc")}
    holds = {m: {"peak": abs(c["port_peak_lambda"] - c["jax_peak_lambda"])
                 <= PEAK_STEPS * step,
                 "median_abs": c["median_abs"] <= MEDIAN_ABS,
                 "pearson_r": c["pearson_r"] >= PEARSON_R}
             for m, c in curves.items()}
    out: Dict[str, Any] = {"curves": curves, "holds": holds}
    if all(all(h.values()) for h in holds.values()):
        out["verdict"] = "closed: the curve pairs"
        return out
    volumes = sorted(set(port_dice) & set(jax_dice))
    p_port = np.stack([port_dice[v] for v in volumes])
    p_jax = np.stack([jax_dice[v] for v in volumes])
    pvalues = {}
    for j, lam in enumerate(lambdas):
        d = p_port[:, j] - p_jax[:, j]
        if np.ptp(d) > 0:
            test = stats.ttest_rel(p_port[:, j], p_jax[:, j])
            pvalues[str(int(lam))] = float(test.pvalue)
    tests = holm(pvalues) if pvalues else {}
    rejected = sorted(int(k) for k, v in tests.items() if v["rejected"])
    out.update(volumes=len(volumes), dice_tests=tests, rejected=rejected)
    if rejected:
        out["verdict"] = (f"a fault in the port: Dice at lambda "
                          f"{rejected[0]}..{rejected[-1]} ({len(rejected)} of "
                          f"{len(tests)} tested)")
    else:
        out["verdict"] = "open: the trajectories part"
    return out


def paired_main(root_dir: str = ".", token: str = TOKEN) -> Dict[str, Any]:
    """The port's JAX-stream sweep under JAX_RNG_DIR against the JAX
    package's under metrics/, with the torch-stream sweep's curves beside
    it; writes DENSE_SWEEP_JAX_RNG_PAIRED."""
    port_token = f"{token}_jaxrng"
    port_dir = os.path.join(root_dir, JAX_RNG_DIR)
    lambdas, jax = read_pooled(os.path.join(root_dir, "metrics",
                                            f"args{token}-lambda.csv"))
    got, port = read_pooled(os.path.join(port_dir,
                                         f"args{port_token}-lambda.csv"))
    if list(got) != list(lambdas):
        raise ValueError(f"the lambda grids differ: {list(got)[:4]}... "
                         f"against {list(lambdas)[:4]}...")
    out = paired_verdict(
        lambdas, port, jax,
        read_volume_dice(os.path.join(port_dir, f"ARGS={port_token}")),
        read_volume_dice(os.path.join(root_dir, "metrics", f"ARGS={token}")))
    torch_stream = os.path.join(root_dir, TORCH_STREAM_DIR,
                                f"args{token}-lambda.csv")
    if os.path.exists(torch_stream):
        _, old = read_pooled(torch_stream)
        out["torch_stream"] = {m: _curve(lambdas, old[m], jax[m])
                               for m in ("dice", "auc")}
    out["lambdas"] = [int(t) for t in lambdas]
    save_results(root_dir, DENSE_SWEEP_JAX_RNG_PAIRED, out)
    return out


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
    p.add_argument("--rng", choices=("torch", "jax"), default="torch",
                   help="jax: train and sweep on the JAX package's streams")
    p.add_argument("--paired", action="store_true",
                   help="hold the JAX-stream sweep's curves against the "
                        "JAX package's (no model, no card)")
    ns = p.parse_args(sys.argv[1:] if argv is None else argv)
    if ns.replot is not None:
        return replot(ns.replot)
    if ns.paired:
        out = paired_main(ns.root)
        print(json.dumps({k: out[k] for k in ("verdict", "curves")}, indent=1))
        return out
    return run(ns.step, ns.vols, ns.root, device=device, rng=ns.rng)


if __name__ == "__main__":
    main()
