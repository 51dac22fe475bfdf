"""Result files of the campaigns, in the JAX package's schema: one JSON
object, written with ``json.dump(indent=1, sort_keys=True)`` to a ``.tmp``
file and moved into place, so that a run cut short leaves the last whole
file (`scripts/flagship_campaign.py:46-50`,
`scripts/seed_replication.py:93-103`)."""

from __future__ import annotations

import json
import os
from typing import Any, Dict

FLAGSHIP = "results/torch_flagship_quality.json"
SEED_REPLICATION = "results/torch_seed_replication.json"
DIFFUSE_CALIBRATION = "results/torch_diffuse_calibration.json"
TRAIN_LONGER = "results/torch_train_longer.json"
DENSE_SWEEP = "results/torch_dense_sweep_full.json"
DENSE_SWEEP_JAX_RNG = "results/torch_dense_sweep_jaxrng/sweep.json"
DENSE_SWEEP_JAX_RNG_PAIRED = "results/torch_dense_sweep_jaxrng_paired.json"
F3_S2D64 = "results/torch_f3_s2d64.json"
F3_TWO_SAMPLE = "results/torch_f3_two_sample.json"
F3_FLAX_ORDER = "results/torch_f3_flax_order_two_sample.json"
F3_JAX_RNG_PAIRED = "results/torch_f3_jax_rng_paired.json"
ROC_3WAY_JAX_RNG = "results/torch_roc_3way_diffuse_sev1.5_jaxrng/run.json"
ROC_3WAY_JAX_RNG_PAIRED = "results/torch_roc_3way_jaxrng_paired.json"
ROC_3WAY_CE_SPREAD = "results/torch_roc_3way_diffuse_sev1.5_jaxrng/ce_spread.json"


def load_results(root_dir: str, name: str) -> Dict[str, Any]:
    """The results file `name` under `root_dir`, or {} when there is none."""
    path = os.path.join(root_dir, name)
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        return json.load(f)


def save_results(root_dir: str, name: str, res: Dict[str, Any]) -> str:
    """Write `res` atomically as `root_dir`/`name`; returns the path."""
    path = os.path.join(root_dir, name)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path + ".tmp", "w") as f:
        json.dump(res, f, indent=1, sort_keys=True)
    os.replace(path + ".tmp", path)
    return path
