"""The port's seeds against the JAX package's.

One result against the seed band: for each metric of a cell of
`results/seed_replication.json` (the n-seed aggregate of mean and
population std), the band mean +- k * std and whether the result falls
inside it (`hold`, `verdict`).

The port's seeds and the JAX package's as two samples (`compare`,
`two_sample`): per cell and metric, Welch's t for the level and the
two-sided F-test of the variances for the spread, each family of p-values
under Holm.  ``python -m anoddpm_torch.campaigns.band [--root DIR] [--out NAME]``
compares the s2d64 cells of DIR's ``results/torch_seed_replication.json``
and ``results/torch_seed_replication_seeds*.json`` (the per-process files
of seeds trained at once) with the checkout's JAX file and writes
``results/torch_f3_two_sample.json`` (or NAME) under DIR, with F3's verdict
by the rule of PERF.md section 2 (`f3_verdict`).

F3's rounding A/B (`flax_order_verdict`): ``... band --flax-order`` holds
the seeds trained in the JAX package's norm order (DIR's
``results/torch_f3_flax_order_seeds*.json``) against the JAX package's
seeds (i) and against the port's default-order seeds of DIR's
``results/torch_seed_replication.json`` (ii), both by the rule above, and
writes both with the verdict to ``results/torch_f3_flax_order_two_sample.json``.

F3 paired (`f3_paired_verdict`): ``... band --jax-rng [--config C]`` pairs
each seed S the port trained on the JAX package's own draws (`rng: "jax"`,
DIR's files of C, `seed_replication.JAX_RNG_FILES`) with JAX seed S, in
C's cells that both files hold, for the seeds the config's epoch-0 gate
marks paired (`EPOCH0_GATES`, `scripts/torch_jax_streams_epoch0.py`), and
writes the paired tests, the verdict and, where F3's cell is one of C's,
P1 to C's file of `PAIRED_FILES` (256syn64s2d, the default:
``results/torch_f3_jax_rng_paired.json``; 256syn128:
``results/torch_jax_rng_256syn128_paired.json``).

The files are read as data; nothing of the JAX side is imported.  Under
the port's default `rng: "torch"` the two packages draw from different
RNGs (Philox, threefry), so one seed of the port is not one seed of the
JAX package and only the samples compare; under `rng: "jax"` they draw
the same numbers, and seed S pairs with seed S."""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
from typing import Dict, Mapping, Optional, Sequence

import numpy as np
from scipy import stats

from ._results import (F3_FLAX_ORDER, F3_JAX_RNG_PAIRED, F3_TWO_SAMPLE,
                       SEED_REPLICATION, save_results)
from .seed_replication import (FLAX_ORDER_RESULTS, JAX_RNG_FILES, MODELS,
                               OWN_FILE_RESULTS, seed_entries)

K = 2.0
CELL = "paper128_ddpm200"
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
# the checkout's copy of the JAX package's seed-replication results
JAX_SEED_RESULTS = os.path.join(ROOT, "results", "seed_replication.json")
ALPHA = 0.05
TWO_SAMPLE_METRICS = ("auc", "dice")
# F3's cell and metric, named before the A/B's runs
F3_CELL = ("s2d64_ddim20_eta1", "dice")


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


def compare(port_values: Sequence[float], jax_values: Sequence[float],
            sides: Sequence[str] = ("port", "jax")) -> Dict[str, object]:
    """Two samples of one metric: n, mean and sample std (ddof 1) of each
    side, under the names `sides`; Welch's t (port minus JAX) with its
    two-sided p; the F-test of the variances, F = var(port) / var(JAX), with
    its two-sided p."""
    a = np.asarray(port_values, np.float64)
    b = np.asarray(jax_values, np.float64)
    if min(a.size, b.size) < 2:
        raise ValueError(f"two samples of 2 or more, got {a.size} and {b.size}")
    welch = stats.ttest_ind(a, b, equal_var=False)
    f = float(a.var(ddof=1) / b.var(ddof=1))
    dfa, dfb = a.size - 1, b.size - 1
    f_p = min(1.0, 2.0 * min(stats.f.cdf(f, dfa, dfb), stats.f.sf(f, dfa, dfb)))
    return {sides[0]: _side(a), sides[1]: _side(b),
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


def two_sample(port: Mapping, jax: Mapping, cells: Sequence[str],
               sides: Sequence[str] = ("port", "jax")) -> Dict[str, object]:
    """`compare` in every cell of `cells` that both results dicts hold with
    two seeds or more, in AUC and Dice (the sides named `sides`); Holm over
    the Welch p-values and, apart, over the F-test p-values; the verdict: a
    fault in the spread if an F-test rejects, in the level if a Welch test
    rejects, else "training spread" (or none, when no cell has two seeds a
    side)."""
    table: Dict[str, Dict[str, object]] = {}
    for cell in cells:
        ours, theirs = seed_entries(port, cell), seed_entries(jax, cell)
        if min(len(ours), len(theirs)) < 2:
            continue
        table[cell] = {f"{sides[0]}_seeds": sorted(ours),
                       f"{sides[1]}_seeds": sorted(theirs)}
        for m in TWO_SAMPLE_METRICS:
            table[cell][m] = compare([ours[s][m] for s in sorted(ours)],
                                     [theirs[s][m] for s in sorted(theirs)],
                                     sides)
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
    return {"alpha": ALPHA, "sides": list(sides), "cells": table,
            "holm": families, "rejected": rejected, "verdict": verdict}


def merged_seed_files(paths: Sequence[str]) -> Dict[str, object]:
    """The {cell}/seed{n} entries of every results file in `paths` in one
    dict (aggregates left out); raises where two files disagree on one."""
    merged: Dict[str, object] = {}
    for path in paths:
        with open(path) as f:
            for key, value in json.load(f).items():
                if key.endswith("/aggregate"):
                    continue
                if merged.get(key, value) != value:
                    raise ValueError(f"{path}: {key} differs from another file")
                merged[key] = value
    return merged


def paired(a: Mapping, b: Mapping, cells: Sequence[str]) -> Dict[str, Dict]:
    """Per cell and metric, the seeds both results dicts hold and a's
    value minus b's for each, with the mean and the largest |difference|:
    the same seed trained twice, here in two norm orders."""
    out: Dict[str, Dict] = {}
    for cell in cells:
        ours, theirs = seed_entries(a, cell), seed_entries(b, cell)
        seeds = sorted(set(ours) & set(theirs))
        if not seeds:
            continue
        out[cell] = {"seeds": seeds}
        for m in TWO_SAMPLE_METRICS:
            d = [ours[s][m] - theirs[s][m] for s in seeds]
            out[cell][m] = {"diff": d, "mean": float(np.mean(d)),
                            "max_abs": float(np.max(np.abs(d)))}
    return out


def flax_order_verdict(vs_jax: Mapping, vs_kernel: Mapping) -> str:
    """F3's verdict from the flax-order seeds against the JAX seeds (i) and
    against the default-order seeds (ii), by the rule of PERF.md section 2:
    "not the norm's order" if (i)'s F-test of DDIM-20 Dice rejects under
    Holm; "the norm's order" if (i) rejects nothing and (ii)'s F-test of
    DDIM-20 Dice, the cell named in advance, has p < ALPHA unadjusted;
    else "open"."""
    named = "/".join(F3_CELL)
    if vs_jax["holm"]["f"].get(named, {}).get("rejected"):
        return "not the norm's order"
    cell, metric = F3_CELL
    f_p = vs_kernel["cells"].get(cell, {}).get(metric, {}).get("f_p")
    if not any(vs_jax["rejected"].values()) and f_p is not None and f_p < ALPHA:
        return "the norm's order"
    return "open"


def f3_verdict(res: Mapping) -> str:
    """F3's verdict on the port's seeds against the JAX seeds (`two_sample`'s
    result), by the rule of PERF.md section 2: "open" while the F-test of
    DDIM-20 Dice rejects under Holm; "closed: the JAX sample's small sigma"
    when nothing rejects; else a new finding, naming what rejects."""
    named = "/".join(F3_CELL)
    if res["holm"]["f"].get(named, {}).get("rejected"):
        return "open"
    others = [f"{test} {k}" for test in ("welch", "f")
              for k in res["rejected"][test]]
    if not others:
        return "closed: the JAX sample's small sigma"
    return "new finding: " + ", ".join(others)


def port_seed_files(root: str):
    """The results files of the port's default-order seeds under `root`:
    the shared file, then the per-process ones."""
    own = sorted(glob.glob(os.path.join(root, OWN_FILE_RESULTS.format("*"))))
    return [os.path.join(root, SEED_REPLICATION)] + own


def flax_order_main(root: str, jax_path: str) -> Dict[str, object]:
    """The A/B's two comparisons and verdict, written under `root`."""
    paths = sorted(glob.glob(os.path.join(root, FLAX_ORDER_RESULTS.format("*"))))
    if not paths:
        raise FileNotFoundError(f"no {FLAX_ORDER_RESULTS.format('*')} under "
                                f"{root}")
    flax = merged_seed_files(paths)
    with open(os.path.join(root, SEED_REPLICATION)) as f:
        kernel = json.load(f)
    with open(jax_path) as f:
        jax = json.load(f)
    cells = MODELS["256syn64s2d"]
    vs_jax = two_sample(flax, jax, cells, ("flax_order", "jax"))
    vs_kernel = two_sample(flax, kernel, cells, ("flax_order", "kernel_order"))
    out = {"files": [os.path.relpath(p, root) for p in paths],
           "named": "/".join(F3_CELL), "vs_jax": vs_jax,
           "vs_kernel_order": vs_kernel,
           "paired_flax_minus_kernel": paired(flax, kernel, cells),
           "verdict": flax_order_verdict(vs_jax, vs_kernel)}
    save_results(root, F3_FLAX_ORDER, out)
    for what, res in (("(i) vs JAX", vs_jax), ("(ii) vs kernel order", vs_kernel)):
        _print(what, res)
    for cell, row in out["paired_flax_minus_kernel"].items():
        print(f"paired, flax order minus kernel order, {cell}: " + "; ".join(
            f"{m} mean {row[m]['mean']:+.4f}, max |d| {row[m]['max_abs']:.4f}"
            for m in TWO_SAMPLE_METRICS))
    print(f"F3's rounding A/B: {out['verdict']}")
    return out


# the epoch-0 gate that decides, before the JAX-stream seeds are scored,
# which of them pair with their JAX twin, per config
EPOCH0_GATE = "results/torch_jax_streams_epoch0.json"
EPOCH0_GATES = {"256syn64s2d": EPOCH0_GATE,
                "256syn128": "results/torch_jax_streams_epoch0_256syn128.json"}
# the paired comparison's file, per config
PAIRED_FILES = {"256syn64s2d": F3_JAX_RNG_PAIRED,
                "256syn128": "results/torch_jax_rng_256syn128_paired.json"}
# the fewest paired seeds the paired rule reads
MIN_PAIRED = 4


def gate_seeds(path: str) -> list:
    """The seeds the epoch-0 gate file marks paired."""
    with open(path) as f:
        gate = json.load(f)
    return sorted(int(s) for s, row in gate["seeds"].items() if row["paired"])


def paired_tests(port: Mapping, jax: Mapping, cells: Sequence[str],
                 seeds: Sequence[int]) -> Dict[str, Dict]:
    """Per cell and metric, over `seeds` (each in both files): the
    differences port(S) - JAX(S), their mean and largest |value|, Pearson's
    r of the two sides, the paired t-test's two-sided p, the JAX side's
    sample std (ddof 1) over the same seeds and mean|d| / that std."""
    out: Dict[str, Dict] = {}
    for cell in cells:
        ours, theirs = seed_entries(port, cell), seed_entries(jax, cell)
        use = [s for s in seeds if s in ours and s in theirs]
        if len(use) < 2:
            continue
        out[cell] = {"seeds": use}
        for m in TWO_SAMPLE_METRICS:
            a = np.array([ours[s][m] for s in use], np.float64)
            b = np.array([theirs[s][m] for s in use], np.float64)
            d = a - b
            sigma = float(b.std(ddof=1))
            out[cell][m] = {
                "port": a.tolist(), "jax": b.tolist(), "diff": d.tolist(),
                "mean": float(d.mean()), "max_abs": float(np.abs(d).max()),
                "pearson_r": float(stats.pearsonr(a, b)[0]),
                "paired_t_p": float(stats.ttest_rel(a, b).pvalue),
                "sigma_jax": sigma,
                "mean_abs_over_sigma": float(np.abs(d).mean() / sigma)}
    return out


def f3_paired_verdict(res: Mapping) -> str:
    """The paired verdict by the rule of PERF.md section 2: "open: the
    streams could not be reproduced" under MIN_PAIRED seeds that the gate
    marks and both files hold, in every cell; "open: the pairs do not hold"
    where the median over the pairs of mean|d| / sigma_JAX exceeds 1; else
    "a fault in the port" (naming what) where P1 (if `res` has one) has
    p < ALPHA or a paired t-test rejects under Holm; else "closed: the
    draws"."""
    paired = min((len(row["seeds"]) for row in res["cells"].values()),
                 default=0)
    if paired < MIN_PAIRED:
        return "open: the streams could not be reproduced"
    if res["median_mean_abs_over_sigma"] > 1.0:
        return "open: the pairs do not hold"
    faults = ([f"P1 {res['p1']['named']} F p {res['p1']['f_p']:.4f}"]
              if "p1" in res and res["p1"]["f_p"] < ALPHA else [])
    faults += [f"paired t {k}" for k, v in res["holm"].items() if v["rejected"]]
    return "a fault in the port: " + ", ".join(faults) if faults else \
        "closed: the draws"


def jax_rng_main(root: str, jax_path: str,
                 config: str = "256syn64s2d") -> Dict[str, object]:
    """The JAX-stream seeds of `config` under `root` against their JAX
    twins (F3 paired at 256syn64s2d), written to the config's file of
    `PAIRED_FILES` under `root`."""
    pattern = JAX_RNG_FILES[config].format("*")
    paths = sorted(glob.glob(os.path.join(root, pattern)))
    if not paths:
        raise FileNotFoundError(f"no {pattern} under {root}")
    port = merged_seed_files(paths)
    with open(jax_path) as f:
        jax = json.load(f)
    seeds = gate_seeds(os.path.join(root, EPOCH0_GATES[config]))
    cells = [c for c in MODELS[config]
             if seed_entries(jax, c) and seed_entries(port, c)]
    table = paired_tests(port, jax, cells, seeds)
    family = {f"{c}/{m}": table[c][m]["paired_t_p"]
              for c in table for m in TWO_SAMPLE_METRICS}
    ratios = [table[c][m]["mean_abs_over_sigma"] for c in table
              for m in TWO_SAMPLE_METRICS]
    out = {"files": [os.path.relpath(p, root) for p in paths],
           "seeds": seeds, "alpha": ALPHA, "cells": table,
           "holm": holm(family) if family else {}}
    cell, metric = F3_CELL
    if cell in MODELS[config]:
        # F3's P1 reads only the config that holds its cell
        ours, theirs = seed_entries(port, cell), seed_entries(jax, cell)
        p1 = compare([ours[s][metric] for s in seeds if s in ours],
                     [theirs[s][metric] for s in sorted(theirs)],
                     ("port_jax_rng", "jax"))
        out["p1"] = {"named": "/".join(F3_CELL), **p1}
    out["median_mean_abs_over_sigma"] = (float(np.median(ratios)) if ratios
                                         else float("inf"))
    out["verdict"] = f3_paired_verdict(out)
    save_results(root, PAIRED_FILES[config], out)
    for c, row in table.items():
        for m in TWO_SAMPLE_METRICS:
            r = row[m]
            print(f"{c} {m}: mean d {r['mean']:+.4f}, max |d| "
                  f"{r['max_abs']:.4f}, r {r['pearson_r']:+.3f}, paired p "
                  f"{r['paired_t_p']:.4f} (Holm "
                  f"{out['holm'][f'{c}/{m}']['adjusted_p']:.4f}), "
                  f"mean|d|/sigma_JAX {r['mean_abs_over_sigma']:.2f}")
    if "p1" in out:
        print(f"P1 {out['p1']['named']}: F {out['p1']['f']:.2f}, p "
              f"{out['p1']['f_p']:.4f}")
    print(f"median mean|d|/sigma_JAX {out['median_mean_abs_over_sigma']:.3f}; "
          f"gated seeds {seeds}, paired in each cell: "
          f"{ {c: row['seeds'] for c, row in table.items()} }")
    print(f"{config} paired: {out['verdict']}")
    return out


def _print(what: str, out: Mapping) -> None:
    a, b = out["sides"]
    print(what)
    for cell, row in out["cells"].items():
        print(f"{cell}: {a} seeds {row[f'{a}_seeds']}, {b} seeds "
              f"{row[f'{b}_seeds']}")
        for m in TWO_SAMPLE_METRICS:
            c = row[m]
            print(f"  {m}: {a} {c[a]['mean']:.4f} +- {c[a]['std']:.4f}, {b} "
                  f"{c[b]['mean']:.4f} +- {c[b]['std']:.4f}; Welch p "
                  f"{c['welch_p']:.4f}, F {c['f']:.2f} p {c['f_p']:.4f}")
    print(f"Holm at {out['alpha']}: Welch rejects {out['rejected']['welch']}, "
          f"F rejects {out['rejected']['f']}: {out['verdict']}")


def main(argv=None):
    p = argparse.ArgumentParser(prog="python -m anoddpm_torch.campaigns.band")
    p.add_argument("--root", default=".",
                   help="reads DIR/results/torch_seed_replication*.json and "
                        "writes DIR/results/torch_f3_two_sample.json")
    p.add_argument("--out", default=F3_TWO_SAMPLE,
                   help="the results file written under DIR")
    p.add_argument("--jax", default=JAX_SEED_RESULTS)
    p.add_argument("--flax-order", action="store_true",
                   help="F3's rounding A/B: the flax-order seeds against the "
                        "JAX seeds and the default-order seeds")
    p.add_argument("--jax-rng", action="store_true",
                   help="F3 paired: the seeds trained on the JAX package's "
                        "draws against their JAX twins")
    p.add_argument("--config", choices=sorted(PAIRED_FILES),
                   default="256syn64s2d",
                   help="with --jax-rng: the config whose seeds pair")
    ns = p.parse_args(sys.argv[1:] if argv is None else argv)
    if ns.jax_rng:
        return jax_rng_main(ns.root, ns.jax, ns.config)
    if ns.flax_order:
        return flax_order_main(ns.root, ns.jax)
    paths = port_seed_files(ns.root)
    port = merged_seed_files(paths)
    with open(ns.jax) as f:
        jax = json.load(f)
    out = two_sample(port, jax, MODELS["256syn64s2d"])
    out["files"] = [os.path.relpath(p, ns.root) for p in paths]
    out["f3_verdict"] = f3_verdict(out)
    save_results(ns.root, ns.out, out)
    _print("the port's seeds vs JAX", out)
    print(f"F3: {out['f3_verdict']}")
    return out


if __name__ == "__main__":
    main()
