"""One result against the JAX package's seed band: for each metric of a
cell of `results/seed_replication.json` (the n-seed aggregate of mean and
population std), the band mean +- k * std and whether the result falls
inside it.  The file is read as data; nothing of the JAX side is imported.

The two packages draw from different RNGs (threefry, Philox), so one seed
of the port is not one seed of the JAX package: only the band compares."""

from __future__ import annotations

import json
import os
from typing import Dict, Mapping, Optional

K = 2.0
CELL = "paper128_ddpm200"
# the checkout's copy of the JAX package's seed-replication results
JAX_SEED_RESULTS = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "results", "seed_replication.json")


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
