"""Stages the campaigns share: the train gate on the epoch count a model's
params-final records, and the scoring of a trained token under one
detection protocol."""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Iterable, Mapping, Optional, Tuple

from ..checkpoint import _args_dir
from ..detect import _load_eval_model, anomalous_metric_calculation
from ..device import DeviceLike


def train_gate(root_dir: str, token: str, target: int
               ) -> Tuple[int, bool, Optional[str]]:
    """(epochs params-final records, whether to train, the resume mode):
    train when params-final records fewer than `target` epochs (or is
    absent), from the newest periodic checkpoint when one exists
    (RESUME_RECENT), else from params-final when it exists (RESUME_FINAL),
    else fresh (None)."""
    base = _args_dir(root_dir, token)
    meta_path = os.path.join(base, "params-final", "meta.json")
    recorded = 0
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            recorded = int(json.load(f).get("n_epoch", 0))
    if recorded >= target:
        return recorded, False, None
    ckpt_dir = os.path.join(base, "checkpoint")
    if os.path.isdir(ckpt_dir) and os.listdir(ckpt_dir):
        return recorded, True, "RESUME_RECENT"
    return recorded, True, "RESUME_FINAL" if recorded > 0 else None


def score(root_dir: str, token: str, protocol: Mapping[str, Any],
          metrics: Iterable[str], device: DeviceLike) -> Dict[str, float]:
    """`metrics` of `token`'s EMA model on the anomalous set under
    `protocol` (the detection arguments it overrides)."""
    eval_args, em, sched = _load_eval_model(root_dir, token, device=device)
    eval_args.update(protocol)
    summary = anomalous_metric_calculation(args=eval_args, root_dir=root_dir,
                                           em=em, sched=sched, device=device)
    return {m: summary[m] for m in metrics}
