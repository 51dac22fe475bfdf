"""The context-encoder baseline: training and anomaly scoring.

Counterpart of `anoddpm_tpu/baselines.py:31-118` (with `torch.optim.Adam`
in place of `optax.adam`).  CLI: ``python -m anoddpm_torch.baselines
<ARG_NUM> [steps]`` trains the context encoder on the config's healthy set,
scores the sliding-window reconstruction error on its anomalous set,
writes metrics/args{n}-ce.csv (header ``dice,iou,precision,recall,fpr,auc``,
"mean +- std" cells) and prints the means.  It runs on the card unless
`device="cpu"`.
"""

from __future__ import annotations

import os
import sys
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from . import metrics as M
from . import streams
from .config import load_args
from .data.datasets import anomalous_dataset_from_args, dataset_from_args
from .data.pipeline import batch_iterator, to_nchw, to_nhwc
from .device import DeviceLike, resolve_device
from .models.context_encoder import (ContextEncoder, context_encoder_from_seed,
                                     make_ce_train_step, sliding_window_error)

CE_METRICS = ("dice", "iou", "precision", "recall", "fpr", "auc")


def train_context_encoder(args, root_dir: str = ".", steps: int = 2000,
                          batch_size: int = 16, base_channels: int = 32,
                          lr: float = 2e-3, seed: int = 0,
                          device: DeviceLike = None) -> ContextEncoder:
    """The baseline trained for `steps` Adam steps (lr 2e-3) on batches of
    the healthy set, each with random box masks; returned in eval mode.
    The weights are drawn on the CPU from `seed`
    (`context_encoder_from_seed`), the masks from the stream seeded
    seed + 1, split once a step (`key(seed + 1)` under `rng: "jax"`, as
    the JAX package splits it)."""
    device = resolve_device(device)
    loader = batch_iterator(dataset_from_args(root_dir, args, train=True),
                            batch_size, shuffle=True, seed=seed)
    sample = next(loader)["image"]      # the JAX trainer's init batch
    model = context_encoder_from_seed(args, seed, sample.shape[-1],
                                      base_channels).to(device)
    optimizer = torch.optim.Adam(model.parameters(), lr=lr)
    step = make_ce_train_step(model, optimizer)
    generator = streams.make(args, seed + 1, device)
    loss = torch.full((), float("nan"))
    for i in range(steps):
        generator, sub = streams.of(generator).split()
        batch = to_nchw(next(loader)["image"]).to(device)
        loss = step(batch, sub)
        if i % max(steps // 10, 1) == 0:
            print(f"CE step {i}: masked-recon loss {float(loss):.5f}",
                  flush=True)
    print(f"CE final loss {float(loss):.5f}")
    return model.eval()


def ce_anomalous_metrics(model: ContextEncoder, args, root_dir: str = ".",
                         window: int = 4, max_volumes: Optional[int] = None
                         ) -> Tuple[Dict[str, float], Tuple]:
    """Per-slice metrics of the sliding-window error map (AUC on the raw
    map, the others on the map thresholded at 0.5) over the anomalous set,
    and the pooled pixel ROC curve (fpr, tpr, thresholds); writes
    metrics/args{n}-ce.csv."""
    device = next(model.parameters()).device
    d_set = anomalous_dataset_from_args(root_dir, args)
    n = len(d_set) if max_volumes is None else min(len(d_set), max_volumes)
    totals = {k: [] for k in CE_METRICS}
    all_scores, all_labels = [], []
    for i in range(n):
        sample = d_set[i]
        images = np.asarray(sample["image"])
        masks = np.asarray(sample["mask"])
        if images.ndim == 3:
            images, masks = images[None], masks[None]
        err = to_nhwc(sliding_window_error(
            model, to_nchw(images).to(device), window))
        for s in range(images.shape[0]):
            pred = (err[s] > 0.5).astype(np.float32)
            totals["auc"].append(M.roc_auc_score(masks[s].astype(np.uint8),
                                                 err[s]))
            totals["dice"].append(M.dice_coeff(None, None, masks[s], mse=pred))
            totals["precision"].append(M.precision(masks[s], pred))
            totals["recall"].append(M.recall(masks[s], pred))
            totals["iou"].append(M.iou(masks[s], pred))
            totals["fpr"].append(M.fpr(masks[s], pred))
            all_scores.append(err[s].reshape(-1))
            all_labels.append(masks[s].reshape(-1))

    summary = {}
    for k, v in totals.items():
        summary[k] = float(np.mean(v))
        summary[k + "_std"] = float(np.std(v))
    roc = M.roc_curve(np.concatenate(all_labels), np.concatenate(all_scores))
    metrics_dir = os.path.join(root_dir, "metrics")
    os.makedirs(metrics_dir, exist_ok=True)
    with open(os.path.join(metrics_dir, f"args{args['arg_num']}-ce.csv"),
              "w") as f:
        f.write(",".join(CE_METRICS) + "\n")
        for k in CE_METRICS:
            f.write(f"{summary[k]:.4f} +- {summary[k + '_std']:.4f},")
        f.write("\n")
    return summary, roc


def main(argv=None, device: DeviceLike = None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        raise SystemExit("usage: python -m anoddpm_torch.baselines <ARG_NUM> "
                         "[train_steps]")
    args = load_args(argv[0])
    steps = int(argv[1]) if len(argv) > 1 else 2000
    model = train_context_encoder(args, steps=steps, device=device)
    summary, _ = ce_anomalous_metrics(model, args)
    print("CE baseline:", {k: round(v, 4) for k, v in summary.items()
                           if not k.endswith("_std")})


if __name__ == "__main__":
    main()
