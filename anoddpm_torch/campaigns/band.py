"""The port's seeds against the JAX package's.

One result against the seed band: for each metric of a cell of
`results/seed_replication.json` (the n-seed aggregate of mean and
population std), the band mean +- k * std and whether the result falls
inside it (`hold`, `verdict`).

The port's seeds and the JAX package's as two samples (`compare`,
`two_sample`): per cell and metric, Welch's t for the level and the
two-sided F-test of the variances for the spread, each family of p-values
under Holm.  ``python -m anoddpm_torch.campaigns.band [--root DIR]``
compares the s2d64 cells of DIR's ``results/torch_seed_replication.json``
with the checkout's JAX file and writes ``results/torch_f3_two_sample.json``
under DIR.

The files are read as data; nothing of the JAX side is imported.  The two
packages draw from different RNGs (threefry, Philox), so one seed of the
port is not one seed of the JAX package: only the samples compare."""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, Mapping, Optional, Sequence

import numpy as np
from scipy import stats

from ._results import F3_TWO_SAMPLE, SEED_REPLICATION, save_results
from .seed_replication import MODELS, seed_entries

K = 2.0
CELL = "paper128_ddpm200"
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
# the checkout's copy of the JAX package's seed-replication results
JAX_SEED_RESULTS = os.path.join(ROOT, "results", "seed_replication.json")
ALPHA = 0.05
TWO_SAMPLE_METRICS = ("auc", "dice")


def load_band(cell: str = CELL, path: Optional[str] = None,
              k: float = K) -> Dict[str, Dict[str, float]]:
    """{metric: {"mean", "std", "n", "lo", "hi"}} of `cell`'s aggregate."""
    with open(path or JAX_SEED_RESULTS) as f:
        agg = json.load(f)[f"{cell}/aggregate"]
    return {m: {"mean": a["mean"], "std": a["std"], "n": a["n"],
                "lo": a["mean"] - k * a["std"], "hi": a["mean"] + k * a["std"]}
            for m, a in agg.items()}


def hold(result: Mapping[str, float], cell: str = CELL,
         path: Optional[str] = None, k: float = K) -> Dict[str, Dict]:
    """For each metric of the band that `result` holds: the band, the value
    and whether lo <= value <= hi."""
    out = {}
    for m, b in load_band(cell, path, k).items():
        if m in result:
            v = float(result[m])
            out[m] = {**b, "value": v, "inside": b["lo"] <= v <= b["hi"]}
    return out


def verdict(result: Mapping[str, float], cell: str = CELL,
            path: Optional[str] = None, k: float = K) -> str:
    """One line: each metric's value, band and inside/outside."""
    held = hold(result, cell, path, k)
    parts = [f"{m} {h['value']:.4f} "
             f"{'inside' if h['inside'] else 'OUTSIDE'} [{h['lo']:.4f}, "
             f"{h['hi']:.4f}]"
             for m, h in held.items()]
    n = next(iter(held.values()))["n"] if held else 0
    return (f"against the JAX band {cell} (mean +- {k:g} std, n = {n}): "
            + "; ".join(parts))


def _side(values: np.ndarray) -> Dict[str, float]:
    return {"n": int(values.size), "mean": float(values.mean()),
            "std": float(values.std(ddof=1))}


def compare(port_values: Sequence[float],
            jax_values: Sequence[float]) -> Dict[str, object]:
    """Two samples of one metric: n, mean and sample std (ddof 1) of each
    side; Welch's t (port minus JAX) with its two-sided p; the F-test of
    the variances, F = var(port) / var(JAX), with its two-sided p."""
    a = np.asarray(port_values, np.float64)
    b = np.asarray(jax_values, np.float64)
    if min(a.size, b.size) < 2:
        raise ValueError(f"two samples of 2 or more, got {a.size} and {b.size}")
    welch = stats.ttest_ind(a, b, equal_var=False)
    f = float(a.var(ddof=1) / b.var(ddof=1))
    dfa, dfb = a.size - 1, b.size - 1
    f_p = min(1.0, 2.0 * min(stats.f.cdf(f, dfa, dfb), stats.f.sf(f, dfa, dfb)))
    return {"port": _side(a), "jax": _side(b),
            "welch_t": float(welch.statistic), "welch_p": float(welch.pvalue),
            "f": f, "f_p": float(f_p)}


def holm(pvalues: Mapping[str, float]) -> Dict[str, Dict[str, object]]:
    """Holm's step-down at ALPHA over a family: {name: {"p", "adjusted_p",
    "rejected"}}; the k-th smallest p (from 0) rejects while it and every
    smaller one lie at or under ALPHA / (m - k)."""
    order = sorted(pvalues, key=lambda k: pvalues[k])
    m = len(order)
    out, running, rejecting = {}, 0.0, True
    for i, name in enumerate(order):
        p = float(pvalues[name])
        running = max(running, min(1.0, (m - i) * p))
        rejecting = rejecting and p <= ALPHA / (m - i)
        out[name] = {"p": p, "adjusted_p": running, "rejected": rejecting}
    return out


def two_sample(port: Mapping, jax: Mapping,
               cells: Sequence[str]) -> Dict[str, object]:
    """`compare` in every cell of `cells` that both results dicts hold with
    two seeds or more, in AUC and Dice; Holm over the Welch p-values and,
    apart, over the F-test p-values; the verdict: a fault in the spread if
    an F-test rejects, in the level if a Welch test rejects, else
    "training spread" (or none, when no cell has two seeds a side)."""
    table: Dict[str, Dict[str, object]] = {}
    for cell in cells:
        ours, theirs = seed_entries(port, cell), seed_entries(jax, cell)
        if min(len(ours), len(theirs)) < 2:
            continue
        table[cell] = {"port_seeds": sorted(ours), "jax_seeds": sorted(theirs)}
        for m in TWO_SAMPLE_METRICS:
            table[cell][m] = compare([ours[s][m] for s in sorted(ours)],
                                     [theirs[s][m] for s in sorted(theirs)])
    families = {test: holm({f"{c}/{m}": table[c][m][f"{test}_p"]
                            for c in table for m in TWO_SAMPLE_METRICS})
                for test in ("welch", "f")}
    rejected = {test: sorted(k for k, v in fam.items() if v["rejected"])
                for test, fam in families.items()}
    faults = [kind for kind, test in (("spread", "f"), ("level", "welch"))
              if rejected[test]]
    verdict = ("no cell with two seeds a side" if not table
               else "a fault in the " + " and the ".join(faults) if faults
               else "training spread")
    return {"alpha": ALPHA, "cells": table, "holm": families,
            "rejected": rejected, "verdict": verdict}


def main(argv=None):
    p = argparse.ArgumentParser(prog="python -m anoddpm_torch.campaigns.band")
    p.add_argument("--root", default=".",
                   help="reads DIR/results/torch_seed_replication.json and "
                        "writes DIR/results/torch_f3_two_sample.json")
    p.add_argument("--jax", default=JAX_SEED_RESULTS)
    ns = p.parse_args(sys.argv[1:] if argv is None else argv)
    with open(os.path.join(ns.root, SEED_REPLICATION)) as f:
        port = json.load(f)
    with open(ns.jax) as f:
        jax = json.load(f)
    out = two_sample(port, jax, MODELS["256syn64s2d"])
    save_results(ns.root, F3_TWO_SAMPLE, out)
    for cell, row in out["cells"].items():
        print(f"{cell}: port seeds {row['port_seeds']}, JAX seeds "
              f"{row['jax_seeds']}")
        for m in TWO_SAMPLE_METRICS:
            c = row[m]
            print(f"  {m}: port {c['port']['mean']:.4f} +- "
                  f"{c['port']['std']:.4f}, JAX {c['jax']['mean']:.4f} +- "
                  f"{c['jax']['std']:.4f}; Welch p {c['welch_p']:.4f}, "
                  f"F {c['f']:.2f} p {c['f_p']:.4f}")
    print(f"Holm at {out['alpha']}: Welch rejects {out['rejected']['welch']}, "
          f"F rejects {out['rejected']['f']}: {out['verdict']}")
    return out


if __name__ == "__main__":
    main()
