"""Metric-CSV post-processing and comparison plots: rolling mean and std of
per-lambda metric curves, ROC CSV assembly with downsampling, and the
dice-vs-lambda comparison figure.

Counterpart of `anoddpm_tpu/graphs.py`, with the `csv` module where the
JAX package uses pandas (the same columns; an empty cell is NaN, as pandas
writes and reads it) and matplotlib imported inside the plotting function.

CLI: ``python -m anoddpm_torch.graphs <csv...> [--window N] [--out DIR]
[--column NAME]``.
"""

from __future__ import annotations

import argparse
import csv
import math
import os
from typing import Dict, List, Optional, Sequence

import numpy as np


def _read_columns(csv_path: str) -> Dict[str, List[str]]:
    """{header: cells} of a CSV, in the header's order."""
    with open(csv_path, newline="") as f:
        rows = list(csv.reader(f))
    header, body = rows[0], rows[1:]
    return {name: [r[i] if i < len(r) else "" for r in body]
            for i, name in enumerate(header)}


def _as_number(cells: List[str]) -> Optional[np.ndarray]:
    """The column as float64 (empty cells NaN), or None when a cell is not
    a number (pandas' non-numeric dtypes)."""
    try:
        return np.array([float(c) if c.strip() else math.nan for c in cells],
                        np.float64)
    except ValueError:
        return None


def _rolling(values: np.ndarray, window: int):
    """pandas' rolling(window, min_periods=1) mean and std (ddof 1, NaN
    where fewer than two values, then 0); NaN cells are left out of a
    window."""
    mu = np.full(values.shape, math.nan)
    std = np.zeros(values.shape)
    for i in range(len(values)):
        win = values[max(0, i - window + 1):i + 1]
        win = win[~np.isnan(win)]
        if win.size:
            mu[i] = win.mean()
        if win.size > 1:
            std[i] = win.std(ddof=1)
    return mu, std


def _cell(v) -> str:
    v = float(v)
    return "" if math.isnan(v) else repr(v)


def _write_columns(out_path: str, cols: Dict[str, np.ndarray]) -> None:
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    names = list(cols)
    n = max((len(v) for v in cols.values()), default=0)
    with open(out_path, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(names)
        for i in range(n):
            w.writerow([_cell(cols[k][i]) for k in names])


def rolling_mean_std(csv_path: str, window: int = 8,
                     out_path: Optional[str] = None) -> Dict[str, np.ndarray]:
    """Per-row rolling mean and std of every numeric column of a metric
    CSV: {"<col>_mu": ..., "<col>_std": ...}, written to `out_path` when
    given."""
    out = {}
    for name, cells in _read_columns(csv_path).items():
        values = _as_number(cells)
        if values is None:
            continue
        out[f"{name}_mu"], out[f"{name}_std"] = _rolling(values, window)
    if out_path:
        _write_columns(out_path, out)
    return out


def reduce_quality(fpr: np.ndarray, tpr: np.ndarray,
                   max_points: int = 200) -> tuple:
    """Downsample an ROC curve to at most about `max_points` points, keeping
    both ends."""
    n = len(fpr)
    if n <= max_points:
        return fpr, tpr
    idx = np.unique(np.r_[0, np.linspace(0, n - 1, max_points).astype(int),
                          n - 1])
    return fpr[idx], tpr[idx]


def make_roc_csv(curves: dict, out_path: str, max_points: int = 200) -> None:
    """Named ROC curves {name: (fpr, tpr)} into one CSV with the columns
    <name>_fpr, <name>_tpr, the shorter curves padded with empty cells."""
    reduced = {name: reduce_quality(np.asarray(f), np.asarray(t), max_points)
               for name, (f, t) in curves.items()}
    longest = max((len(f) for f, _ in reduced.values()), default=0)
    cols = {}
    for name, (f, t) in reduced.items():
        pad = np.full(longest - len(f), np.nan)
        cols[f"{name}_fpr"] = np.r_[f, pad]
        cols[f"{name}_tpr"] = np.r_[t, pad]
    _write_columns(out_path, cols)


def graph_dice_comparison(csvs: Sequence[str], labels: Sequence[str],
                          out_path: str, column: str = "dice",
                          window: int = 8) -> None:
    """`column` against lambda for each CSV, rolling mean with a band of one
    rolling std; CSVs without the column are left out."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    plt.figure(dpi=150)
    for path, label in zip(csvs, labels):
        cols = _read_columns(path)
        if column not in cols:
            continue
        mu, std = _rolling(_as_number(cols[column]), window)
        x = _as_number(cols["t"]) if "t" in cols else np.arange(len(mu))
        plt.plot(x, mu, label=label)
        plt.fill_between(x, mu - std, mu + std, alpha=0.2)
    plt.xlabel("$\\lambda$")
    plt.ylabel(column)
    plt.legend()
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    plt.savefig(out_path, bbox_inches="tight")
    plt.close("all")


def main(argv: Optional[List[str]] = None):
    p = argparse.ArgumentParser()
    p.add_argument("csvs", nargs="+")
    p.add_argument("--window", type=int, default=8)
    p.add_argument("--out", default="final-outputs")
    p.add_argument("--column", default="dice")
    ns = p.parse_args(argv)
    os.makedirs(ns.out, exist_ok=True)
    for path in ns.csvs:
        stem = os.path.splitext(os.path.basename(path))[0]
        rolling_mean_std(path, ns.window,
                         os.path.join(ns.out, f"{stem}-mu-std.csv"))
    graph_dice_comparison(ns.csvs, [os.path.basename(c) for c in ns.csvs],
                          os.path.join(ns.out, "dice-comparison.png"),
                          column=ns.column, window=ns.window)


if __name__ == "__main__":
    main()
