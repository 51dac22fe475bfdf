"""Anomaly-detection entry point, headline protocol:
``python -m anoddpm_torch.detect [CHECKPOINT] <ARG_NUM> [VB=n]``.

Counterpart of `anoddpm_tpu/detect.py:82-231, 537-545`: every anomalous
slice is q-jumped to t = lambda - 1 (lambda = 200, clamped to T) and
denoised by lambda reverse steps; AUC is computed on the raw square-error
map and the other metrics on the map thresholded at 0.5; the summary goes to
metrics/args{n}.csv with header ``dice,ssim,iou,precision,recall,fpr,auc``
and "mean +- std" cells.

Images and masks cross the public functions as NHWC numpy arrays, as in the
JAX package.  The entry points run on the card unless the caller passes
`device="cpu"`.
"""

from __future__ import annotations

import os
import sys
import time
from typing import Dict, Optional

import numpy as np
import torch

from . import diffusion as dmod
from . import metrics as M
from .checkpoint import load_parameters
from .config import resolve_in_channels
from .data.datasets import anomalous_dataset_from_args
from .device import DeviceLike, resolve_device
from .models.unet import unet_from_args
from .ops.noise import sampler_from_args
from .schedule import schedule_from_args

METRIC_NAMES = ("dice", "ssim", "iou", "precision", "recall", "fpr", "auc")
_USAGE = "usage: python -m anoddpm_torch.detect [CHECKPOINT] <ARG_NUM> [VB=n]"


def _load_eval_model(root_dir: str, token: str, use_checkpoint: bool = False,
                     device: DeviceLike = None):
    """(args, EMA model in eval mode on `device`, schedule on `device`)."""
    device = resolve_device(device)
    args, payload, _ = load_parameters(root_dir, token,
                                       use_checkpoint=use_checkpoint)
    with torch.device(device):
        model = unet_from_args(args, resolve_in_channels(args))
    model.load_state_dict(payload["ema"])
    return args, model.eval(), schedule_from_args(args).to(device)


def evaluate_anomaly_batch(em, sched, images, masks, generator: torch.Generator,
                           noise_sampler, t_distance: int = 200,
                           fb=None) -> Dict[str, list]:
    """Metrics and NHWC reconstruction for one (S, H, W, C) batch of
    anomalous slices; an (H, W, C) sample is a batch of one.  Runs on the
    device of `em`'s parameters."""
    images = np.asarray(images)
    masks = np.asarray(masks)
    if images.ndim == 3:
        images = images[None]
    if masks.ndim == 3:
        masks = masks[None]
    if fb is None:
        fb = lambda x, g: dmod.forward_backward(
            em, sched, x, t_distance, g, noise_sampler=noise_sampler,
            denoise_sampler=noise_sampler)
    device = next(em.parameters()).device
    x = torch.from_numpy(np.ascontiguousarray(
        images.transpose(0, 3, 1, 2), np.float32)).to(device)
    with torch.inference_mode():
        recon = fb(x, generator)
    recon = recon.permute(0, 2, 3, 1).cpu().numpy()
    batched = M.batched_anomaly_metrics(images, recon, masks)
    out = {k: [float(v) for v in batched[k]] for k in METRIC_NAMES}
    return out, recon


def anomalous_metric_calculation(args=None, root_dir: str = ".",
                                 token: Optional[str] = None,
                                 em=None, sched=None,
                                 t_distance: int = 200,
                                 max_volumes: Optional[int] = None,
                                 use_checkpoint: bool = False,
                                 volume_batch: Optional[int] = None,
                                 device: DeviceLike = None) -> Dict[str, float]:
    """The headline-metric producer: lambda = 200 partial diffusion per
    anomalous slice; writes metrics/args{n}.csv and returns the summary.

    `volume_batch` (or args["volume_batch"]) runs the slices of that many
    volumes as one batch; `args["recon_repeats"]` averages that many
    reconstructions before the square-error map."""
    device = resolve_device(device)
    if em is None:
        args, em, sched = _load_eval_model(root_dir, token, use_checkpoint,
                                           device)
    elif next(em.parameters()).device.type != device.type:
        raise ValueError(f"model on {next(em.parameters()).device}, "
                         f"asked to run on {device}")
    sched = sched.to(device)
    if str(args.get("sampler") or "ddpm") == "ddim":
        raise NotImplementedError("sampler=ddim is not ported yet (ROADMAP.md, "
                                  "Queue 1: DDIM)")
    # lambda = 200 against T = 1000 in the reference; clamp for short
    # schedules where 200 would index past T
    t_distance = min(t_distance, sched.num_timesteps)
    noise_sampler = sampler_from_args(args)
    d_set = anomalous_dataset_from_args(root_dir, args)
    n_volumes = len(d_set) if max_volumes is None else min(len(d_set),
                                                           max_volumes)

    def fb(x, g):
        return dmod.forward_backward(em, sched, x, t_distance, g,
                                     noise_sampler=noise_sampler)

    repeats = int(args.get("recon_repeats") or 1)
    if repeats > 1:
        one = fb

        def fb(x, g):
            return sum(one(x, g) for _ in range(repeats)) / repeats

    generator = torch.Generator(device=device)
    generator.manual_seed(int(args.get("seed", 0) or 0) + 1)
    totals = {k: [] for k in METRIC_NAMES}
    start = time.time()
    vb = max(int(volume_batch or args.get("volume_batch") or 1), 1)
    for g0 in range(0, n_volumes, vb):
        group = [d_set[i] for i in range(g0, min(g0 + vb, n_volumes))]
        imgs = [np.asarray(s["image"]) for s in group]
        msks = [np.asarray(s["mask"]) for s in group]
        imgs = [a[None] if a.ndim == 3 else a for a in imgs]
        msks = [a[None] if a.ndim == 3 else a for a in msks]
        batch_out, _ = evaluate_anomaly_batch(
            em, sched, np.concatenate(imgs), np.concatenate(msks), generator,
            noise_sampler, t_distance, fb=fb)
        for k, v in batch_out.items():
            totals[k].extend(v)
        if (g0 // vb) % max(4 // vb, 1) == 0:
            name = str(group[0].get("filenames", g0))
            print(f"[{g0 + len(group)}/{n_volumes}] {name}: "
                  f"dice {np.mean(batch_out['dice']):.4f}, "
                  f"AUC {np.mean(batch_out['auc']):.4f}, "
                  f"elapsed {time.time() - start:.0f}s", flush=True)

    print("\nOverall:")
    summary = {}
    for k in totals:
        summary[k] = float(np.mean(totals[k]))
        summary[k + "_std"] = float(np.std(totals[k]))
        print(f"{k}: {summary[k]:.4f} +- {summary[k + '_std']:.4f}")
    _write_metrics_csv(root_dir, args["arg_num"], summary)
    return summary


def _write_metrics_csv(root_dir: str, arg_num, summary) -> None:
    """metrics/args{n}.csv in the reference's format."""
    metrics_dir = os.path.join(root_dir, "metrics")
    os.makedirs(metrics_dir, exist_ok=True)
    with open(os.path.join(metrics_dir, f"args{arg_num}.csv"), "w") as f:
        f.write(",".join(METRIC_NAMES) + "\n")
        for k in METRIC_NAMES:
            f.write(f"{summary[k]:.4f} +- {summary[k + '_std']:.4f},")
        f.write("\n")


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    use_checkpoint = bool(argv) and argv[0] == "CHECKPOINT"
    if use_checkpoint:
        argv = argv[1:]
    if not argv:
        raise SystemExit(_USAGE)
    token, vb = argv[0], None
    for a in argv[1:]:
        if a.startswith("VB="):
            vb = int(a[3:])
        elif a in ("validation", "graph", "roc", "methodA", "methodB"):
            raise NotImplementedError(
                f"detect mode {a!r} is not ported yet (ROADMAP.md, Queue 1: "
                "detection sweeps)")
        elif a != "metrics":
            raise SystemExit(_USAGE)
    anomalous_metric_calculation(token=token, use_checkpoint=use_checkpoint,
                                 volume_batch=vb)


if __name__ == "__main__":
    main()
