"""The paper's 3-way pixel ROC on the diffuse lesion regime, on the JAX
package's random streams:
``python -m anoddpm_torch.campaigns.roc_3way [--root DIR]``.

Counterpart of the JAX package's
``python -m anoddpm_tpu.detect 256syn64s2d_s0 roc 256syn64s2dg
CE=256syn64s2d LESION=diffuse:1.5`` (`scripts/r3_post_sweep_queue.sh:14`,
whose curves are ``results/roc_3way_diffuse_sev1.5.csv``).  It trains
the two diffusion models on `rng: "jax"`, each at its JAX recipe and as a
process of its own, both at once (`--train simplex|gauss` is one of them):

- ``256syn64s2d_s0_jaxrng``: seed 0 of the band recipe
  (`seed_replication.train_args_for(..., "jax_rng")`: 8 substeps, the flax
  norm order, `bf16_norm` off), held to PR 15's epoch-0 gate (its loss
  within `GATE` of the TPU log, `EPOCH0_LOG`);
- ``256syn64s2dg_jaxrng``: configs/args256syn64s2dg.json as the JAX
  trainer takes it (1 step a dispatch, the flax norm order, `bf16_norm`
  off); its epoch-0 loss is printed, not held (no TPU log).

Both skip the test-set suite, which reads the trained weights and changes
none.  Then it scores them through the detection CLI's form of the JAX
command, the context encoder on the config ``256syn64s2d_jaxrng``
(args256syn64s2d.json on `rng: "jax"`, written under DIR/configs), and
copies the curves into ``results/torch_roc_3way_diffuse_sev1.5_jaxrng/``
with ``run.json`` (walls, epoch-0 losses, AUCs).  A model whose
params-final records its epochs is not trained again.

``--paired`` holds the port's curves against the JAX file by
`paired_verdict` (the rule of PERF.md section 2) and writes
``results/torch_roc_3way_jaxrng_paired.json`` (``--port-dir`` and
``--out`` pair another run's curves); ``--replot DIR`` draws the PNG from
DIR's CSV on a machine with matplotlib.  ``--ce-spread N`` runs the
context encoder's stage alone N times under each of `CE_SETTINGS` and
writes its AUCs to ``ce_spread.json`` there; ``--ce-mean N`` runs it N
times under cuDNN's default alone and holds the mean of the N AUCs to the
JAX file's CE AUC by `ce_mean_verdict` (``ce_default10.json``).
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import json
import os
import shutil
import subprocess
import sys
import time
from typing import Any, Dict, Mapping, Tuple

import numpy as np

from .. import graphs
from .. import metrics as M
from ..config import load_args
from ..device import DeviceLike
from ..train import train
from ._results import (ROC_3WAY_CE_MEAN, ROC_3WAY_CE_SPREAD, ROC_3WAY_JAX_RNG,
                       ROC_3WAY_JAX_RNG_PAIRED, load_results, save_results)
from ._stages import train_gate
from .band import ROOT
from .seed_replication import NORM_ORDERS, train_args_for

SIMPLEX, GAUSS = "256syn64s2d", "256syn64s2dg"
CE_CONFIG = "256syn64s2d"
CE_TOKEN = f"{CE_CONFIG}_jaxrng"
LESION = "diffuse:1.5"
OUT_DIR = os.path.dirname(ROC_3WAY_JAX_RNG)
CSV_NAME = "roc_3way_diffuse_sev1.5.csv"
JAX_CSV = "results/roc_3way_diffuse_sev1.5.csv"
# seed 0's epoch-0 loss on the TPU, and the distance that pairs (PR 15)
EPOCH0_LOG = ("results/seed_replication.log:90", 0.15949)
GATE = 0.02
# the curves of each file: (JAX label, port label)
CURVES = {"simplex": (f"args{SIMPLEX}_s0", f"args{SIMPLEX}_s0_jaxrng"),
          "gauss": (f"args{GAUSS}", f"args{GAUSS}_jaxrng"),
          "ce": ("context-encoder", "context-encoder")}


def model_args(which: str, root_dir: str = "."):
    """The training args of the simplex (seed 0 of the band recipe) or the
    Gaussian model on the JAX streams, test-set suite off."""
    if which == "simplex":
        args = train_args_for(SIMPLEX, 0, root_dir, "jax_rng")
    else:
        args = copy.deepcopy(load_args(
            GAUSS, config_dir=os.path.join(root_dir, "configs")))
        args.update(NORM_ORDERS["jax_rng"][0])
        args["arg_num"] = f"{GAUSS}_jaxrng"
    args["skip_test_eval"] = True
    return args


def train_one(which: str, root_dir: str = ".", device: DeviceLike = None):
    """Train one model unless its params-final records its epochs."""
    args = model_args(which, root_dir)
    _, needed, resume = train_gate(root_dir, args["arg_num"], int(args["EPOCHS"]))
    if needed:
        print(f"=== training {args['arg_num']} ({args['EPOCHS']} epochs, "
              f"resume: {resume})", flush=True)
        train(args, root_dir=root_dir, resume=resume, device=device)


def write_ce_config(root_dir: str = ".") -> str:
    """configs/args{CE_TOKEN}.json under `root_dir`: the CE's config on the
    JAX streams."""
    config_dir = os.path.join(root_dir, "configs")
    with open(os.path.join(config_dir, f"args{CE_CONFIG}.json")) as f:
        raw = json.load(f)
    path = os.path.join(config_dir, f"args{CE_TOKEN}.json")
    with open(path, "w") as f:
        json.dump({**raw, "rng": "jax"}, f, indent=1)
    return path


def roc_argv(simplex: str, gauss: str, ce: str, lesion: str = LESION):
    """The detection CLI's arguments of the 3-way ROC."""
    return [simplex, "roc", gauss, f"CE={ce}", f"LESION={lesion}"]


def score(root_dir: str, argv, device: DeviceLike = None) -> None:
    """`python -m anoddpm_torch.detect <argv>` run from `root_dir` (the CLI
    reads and writes under its working directory)."""
    from .. import detect
    print("python -m anoddpm_torch.detect " + " ".join(argv), flush=True)
    cwd = os.getcwd()
    os.chdir(root_dir)
    try:
        detect.main(list(argv), device=device)
    finally:
        os.chdir(cwd)


def epoch0_loss(root_dir: str, token: str) -> float:
    """The epoch-0 loss of `token`'s train JSONL."""
    with open(os.path.join(root_dir, "metrics", f"args{token}-train.jsonl")) as f:
        return float(json.loads(f.readline())["loss"])


def _train_both(root_dir: str, device: str, out_dir: str) -> Dict[str, float]:
    """Both models' trainings as two processes at once; their walls.  A
    training that fails stops the other."""
    walls = {}
    with contextlib.ExitStack() as stack:
        procs = {}
        for which in ("simplex", "gauss"):
            args = model_args(which, root_dir)
            if not train_gate(root_dir, args["arg_num"], int(args["EPOCHS"]))[1]:
                continue
            log = stack.enter_context(
                open(os.path.join(out_dir, f"train_{which}.log"), "w"))
            proc = subprocess.Popen(
                [sys.executable, "-m", "anoddpm_torch.campaigns.roc_3way",
                 "--train", which, "--root", root_dir, "--device", device],
                stdout=log, stderr=subprocess.STDOUT)
            stack.callback(_stop, proc)
            procs[which] = (proc, time.time())
        for which, (proc, t0) in procs.items():
            rc = proc.wait()
            walls[which] = time.time() - t0
            print(f"training {which}: rc {rc} after {walls[which]:.1f} s",
                  flush=True)
            if rc != 0:
                raise SystemExit(f"training {which} failed (rc {rc})")
    return walls


def _stop(proc: subprocess.Popen) -> None:
    if proc.poll() is None:
        proc.terminate()
        proc.wait()


def run(root_dir: str = ".", device: str = "cuda") -> Dict[str, Any]:
    out_dir = os.path.join(root_dir, OUT_DIR)
    os.makedirs(out_dir, exist_ok=True)
    res = load_results(root_dir, ROC_3WAY_JAX_RNG)
    walls = _train_both(root_dir, device, out_dir)
    if walls:
        res["train_seconds"] = walls
        res.pop("auc", None)   # the curves of other weights
    tokens = {w: model_args(w, root_dir)["arg_num"] for w in ("simplex", "gauss")}
    losses = {w: epoch0_loss(root_dir, t) for w, t in tokens.items()}
    log, want = EPOCH0_LOG
    res["epoch0"] = {"loss": losses, "simplex_log": want, "log": log,
                     "simplex_gate": abs(losses["simplex"] - want) / want <= GATE}
    print(f"epoch-0 loss: simplex {losses['simplex']:.5f} (TPU log {want}, "
          f"gate {GATE:.0%}: {'pass' if res['epoch0']['simplex_gate'] else 'FAIL'}),"
          f" gauss {losses['gauss']:.5f} (no log, not held)", flush=True)
    save_results(root_dir, ROC_3WAY_JAX_RNG, res)
    if "auc" not in res:
        write_ce_config(root_dir)
        t0 = time.time()
        score(root_dir, roc_argv(tokens["simplex"], tokens["gauss"], CE_TOKEN),
              device)
        res["score_seconds"] = time.time() - t0
        shutil.copy(os.path.join(root_dir, "metrics", "roc-comparison.csv"),
                    os.path.join(out_dir, CSV_NAME))
        png = os.path.join(root_dir, "final-outputs", "roc-comparison.png")
        if os.path.exists(png):
            shutil.copy(png, os.path.join(out_dir, CSV_NAME[:-4] + ".png"))
        res["auc"] = {k: auc for k, (auc, _) in
                      curve_stats(read_curves(os.path.join(out_dir, CSV_NAME))).items()}
        save_results(root_dir, ROC_3WAY_JAX_RNG, res)
    print(json.dumps(res, indent=1))
    return res


# --- the port's curves against the JAX package's ---------------------------

PAIR_ABS = 0.01      # every |port AUC - JAX AUC| within this: the ROC pairs
GAP_ABS = 0.05       # the simplex - Gaussian gap within this of JAX's
CE_PARITY = 0.05     # the port's CE - simplex within +-this
TPR_AT = (0.01, 0.05, 0.10)


def read_curves(path: str) -> Dict[str, Tuple[np.ndarray, np.ndarray]]:
    """{label: (fpr, tpr)} of a roc-comparison CSV, the padding dropped."""
    cols = graphs._read_columns(path)
    out = {}
    for name in cols:
        if name.endswith("_fpr"):
            label = name[:-4]
            f = graphs._as_number(cols[name])
            t = graphs._as_number(cols[f"{label}_tpr"])
            keep = ~np.isnan(f)
            out[label] = (f[keep], t[keep])
    return out


def curve_stats(curves) -> Dict[str, Tuple[float, Dict[str, float]]]:
    """{label: (AUC, {FPR: TPR interpolated on the curve's points})}."""
    return {label: (M.auc(f, t),
                    {str(x): float(np.interp(x, f, t)) for x in TPR_AT})
            for label, (f, t) in curves.items()}


def paired_verdict(port: Mapping[str, float], jax: Mapping[str, float]
                   ) -> Dict[str, Any]:
    """The rule written before the card run (PERF.md section 2), on the
    AUCs {"simplex", "gauss", "ce"} of each side.  "closed: the ROC pairs"
    when every |port - JAX| <= PAIR_ABS; "a fault in the port" (naming the
    curves) when the simplex - Gaussian gap differs from JAX's by more
    than GAP_ABS, or the Gaussian AUC lies on the other side of .5 from
    JAX's, or the port's CE - simplex falls outside +-CE_PARITY; else
    "open: the curves part"."""
    delta = {k: port[k] - jax[k] for k in ("simplex", "gauss", "ce")}
    gap = {"port": port["simplex"] - port["gauss"],
           "jax": jax["simplex"] - jax["gauss"]}
    ce_minus = {"port": port["ce"] - port["simplex"],
                "jax": jax["ce"] - jax["simplex"]}
    out: Dict[str, Any] = {"delta": delta, "gap": gap, "ce_minus_simplex": ce_minus}
    faults = []
    if abs(gap["port"] - gap["jax"]) > GAP_ABS:
        faults.append("the simplex - Gaussian gap")
    if (port["gauss"] - 0.5) * (jax["gauss"] - 0.5) < 0:
        faults.append("the Gaussian curve across .5")
    if abs(ce_minus["port"]) > CE_PARITY:
        faults.append("the context encoder - simplex difference")
    if all(abs(d) <= PAIR_ABS for d in delta.values()):
        out["verdict"] = "closed: the ROC pairs"
    elif faults:
        out["verdict"] = "a fault in the port: " + "; ".join(faults)
    else:
        out["verdict"] = "open: the curves part"
    return out


def paired_main(root_dir: str = ".", port_dir: str = OUT_DIR,
                out: str = ROC_3WAY_JAX_RNG_PAIRED) -> Dict[str, Any]:
    """The port's curves under `port_dir` against JAX_CSV (both relative
    to `root_dir`); writes `out` there."""
    port_csv = os.path.join(port_dir, CSV_NAME)
    sides = {"jax": curve_stats(read_curves(os.path.join(root_dir, JAX_CSV))),
             "port": curve_stats(read_curves(os.path.join(root_dir, port_csv)))}
    auc = {side: {k: sides[side][CURVES[k][i]][0] for k in CURVES}
           for i, side in enumerate(("jax", "port"))}
    tpr = {side: {k: sides[side][CURVES[k][i]][1] for k in CURVES}
           for i, side in enumerate(("jax", "port"))}
    res = paired_verdict(auc["port"], auc["jax"])
    res.update(auc=auc, tpr_at_fpr=tpr, jax_csv=JAX_CSV, port_csv=port_csv)
    save_results(root_dir, out, res)
    return res


# --- the context encoder's run-to-run spread on the card -------------------

# cuDNN's deterministic algorithms, and TF32 in convolutions and matmuls;
# None leaves the process's setting as it is (PyTorch's default: cuDNN
# free to pick nondeterministic algorithms, TF32 in cuDNN's convolutions)
CE_SETTINGS = {"default": (None, None), "deterministic": (True, None),
               "deterministic_fp32": (True, False)}


def ce_auc(root_dir: str, device: DeviceLike = None) -> float:
    """The context encoder's stage of the 3-way ROC alone: trained and
    scored as `roc_argv`'s CE= and LESION= have `detect.roc_data` do it."""
    from .. import detect
    kind, _, sev = LESION.partition(":")
    curves = detect.roc_data(
        [], root_dir=root_dir, ce_token=CE_TOKEN, device=device,
        args_override={"lesion_kind": kind, "lesion_severity": float(sev)})
    return M.auc(*curves["context-encoder"])


def ce_spread(root_dir: str = ".", repeats: int = 3, device: str = "cuda",
              settings=tuple(CE_SETTINGS),
              out: str = ROC_3WAY_CE_SPREAD) -> Dict[str, Any]:
    """`ce_auc` `repeats` times in a row under each of `settings` (names of
    CE_SETTINGS), on the same keys and data: each setting's AUCs, walls,
    spread (max - min) and flags, written to `out` under `root_dir`."""
    import torch
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    write_ce_config(root_dir)
    saved = (cudnn.deterministic, cudnn.allow_tf32, matmul.allow_tf32)
    res: Dict[str, Any] = {}
    try:
        for name in settings:
            deterministic, tf32 = CE_SETTINGS[name]
            cudnn.deterministic, cudnn.allow_tf32, matmul.allow_tf32 = saved
            if deterministic is not None:
                cudnn.deterministic = deterministic
            if tf32 is not None:
                cudnn.allow_tf32 = matmul.allow_tf32 = tf32
            runs = res[name] = {"flags": {
                "cudnn_deterministic": cudnn.deterministic,
                "cudnn_allow_tf32": cudnn.allow_tf32,
                "matmul_allow_tf32": matmul.allow_tf32}, "auc": [], "seconds": []}
            for _ in range(repeats):
                t0 = time.time()
                runs["auc"].append(ce_auc(root_dir, device))
                runs["seconds"].append(time.time() - t0)
                print(f"CE spread {name}: AUC {runs['auc'][-1]!r} in "
                      f"{runs['seconds'][-1]:.1f} s", flush=True)
            runs["spread"] = max(runs["auc"]) - min(runs["auc"])
            save_results(root_dir, out, res)
    finally:
        cudnn.deterministic, cudnn.allow_tf32, matmul.allow_tf32 = saved
    print(json.dumps(res, indent=1))
    return res


# the rule of PERF.md section 2 for the CE's mean over fresh default runs:
# the one-sample t-test against the JAX file's CE AUC at CE_MEAN_ALPHA, and
# the mean's distance from it
CE_MEAN_ALPHA = 0.05
CE_MEAN_ABS = 0.005


def jax_ce_auc(root_dir: str = ROOT) -> float:
    """The context encoder's AUC in the JAX file (trapezoid of its curve)."""
    curves = read_curves(os.path.join(root_dir, JAX_CSV))
    return M.auc(*curves[CURVES["ce"][0]])


def ce_mean_verdict(aucs, jax_auc: float) -> Dict[str, Any]:
    """"closed: the CE pairs in the mean" where the one-sample t-test of
    `aucs` against `jax_auc` does not reject at CE_MEAN_ALPHA and |mean -
    jax_auc| <= CE_MEAN_ABS; else "open", with the numbers."""
    from scipy import stats
    a = np.asarray(aucs, np.float64)
    test = stats.ttest_1samp(a, jax_auc)
    mean = float(a.mean())
    closed = test.pvalue >= CE_MEAN_ALPHA and abs(mean - jax_auc) <= CE_MEAN_ABS
    return {"n": int(a.size), "mean": mean, "std": float(a.std(ddof=1)),
            "jax_auc": float(jax_auc), "mean_minus_jax": mean - jax_auc,
            "t": float(test.statistic), "p": float(test.pvalue),
            "verdict": ("closed: the CE pairs in the mean" if closed
                        else "open: the CE's mean does not pair")}


def ce_mean(root_dir: str = ".", repeats: int = 10,
            device: str = "cuda") -> Dict[str, Any]:
    """`ce_auc` `repeats` times under cuDNN's default alone, held to the
    checkout's JAX file by `ce_mean_verdict`; written to ROC_3WAY_CE_MEAN."""
    res = ce_spread(root_dir, repeats, device, ("default",), ROC_3WAY_CE_MEAN)
    res["vs_jax"] = ce_mean_verdict(res["default"]["auc"], jax_ce_auc())
    save_results(root_dir, ROC_3WAY_CE_MEAN, res)
    print(json.dumps(res["vs_jax"], indent=1))
    return res


def replot(out_dir: str) -> str:
    """The ROC figure from the CSV under `out_dir`; returns its path."""
    from ..detect import _roc_plot
    path = os.path.join(out_dir, CSV_NAME[:-4] + ".png")
    _roc_plot(read_curves(os.path.join(out_dir, CSV_NAME)), path)
    return path


def main(argv=None):
    p = argparse.ArgumentParser(prog="python -m anoddpm_torch.campaigns.roc_3way")
    p.add_argument("--root", default=".")
    p.add_argument("--device", default="cuda")
    p.add_argument("--train", choices=("simplex", "gauss"), default=None,
                   help="train this one model and stop")
    p.add_argument("--paired", action="store_true",
                   help="hold the port's curves against the JAX package's "
                        "(no model, no card)")
    p.add_argument("--port-dir", default=OUT_DIR,
                   help="with --paired: the port's curves' directory")
    p.add_argument("--out", default=ROC_3WAY_JAX_RNG_PAIRED,
                   help="with --paired: the file to write")
    p.add_argument("--ce-spread", metavar="N", type=int, default=None,
                   help="the context encoder's stage alone, N times under "
                        "each of CE_SETTINGS")
    p.add_argument("--ce-mean", metavar="N", type=int, default=None,
                   help="the context encoder's stage alone, N times under "
                        "cuDNN's default, its mean held to the JAX file's")
    p.add_argument("--replot", metavar="DIR", default=None,
                   help="draw the ROC figure from the CSV under DIR")
    ns = p.parse_args(sys.argv[1:] if argv is None else argv)
    if ns.replot is not None:
        return replot(ns.replot)
    if ns.paired:
        out = paired_main(ns.root, ns.port_dir, ns.out)
        print(json.dumps(out, indent=1))
        return out
    if ns.ce_spread is not None:
        return ce_spread(ns.root, ns.ce_spread, ns.device)
    if ns.ce_mean is not None:
        return ce_mean(ns.root, ns.ce_mean, ns.device)
    if ns.train is not None:
        return train_one(ns.train, ns.root, ns.device)
    return run(ns.root, ns.device)


if __name__ == "__main__":
    main()
