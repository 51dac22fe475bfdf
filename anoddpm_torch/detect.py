"""Anomaly-detection entry point:
``python -m anoddpm_torch.detect [CHECKPOINT] <ARG_NUM> [MODE ...]``.

Counterpart of `anoddpm_tpu/detect.py` on one card.  Modes:

- ``metrics`` (the default; ``VB=n``): the headline protocol.  Every
  anomalous slice is q-jumped to t = lambda - 1 (lambda = 200, clamped to
  T) and denoised by lambda reverse steps (``sampler: ddim``: `ddim_steps`
  strided steps, default 25, at `ddim_eta`, default 0); AUC on the raw
  square-error map, the other metrics on the map thresholded at 0.5;
  metrics/args{n}.csv with header ``dice,ssim,iou,precision,recall,fpr,auc``
  and "mean +- std" cells.
- ``validation``: per-slice "whole"-sequence videos and heatmaps, then the
  method sweeps by noise kind (`anomalous_validation`).
- ``graph`` (``DENSE``, ``STEP=s``, ``VOLS=n``, ``LB=b``): per-lambda
  metric curves, the lambda grid riding the batch axis
  (`graph_data`).
- ``roc <ARG_NUM2> ...`` (``LESION=kind[:severity]``, ``CE=<cfg>``): the
  pixel ROC comparison of several checkpoints (`roc_data`), with the
  context-encoder baseline trained on <cfg>'s healthy set.
- ``methodA`` / ``methodB``: detection methods A and B on the first
  anomalous slice.

The artifact paths and CSV headers are the JAX package's.  Images and
masks cross the public functions as NHWC numpy arrays.  The entry points
run on the card unless the caller passes `device="cpu"`.

Data parallel (`parallel.mesh`): under ``torchrun --nproc_per_node=N``
the ``metrics`` mode runs `sharded_anomalous_metrics`; `graph_data` and
`roc_data` take a `mesh` too.  Each rank reconstructs its rows of every
batch, drawing the noise of the whole batch from a generator seeded alike
on every rank, so N ranks compute what one computes; rank 0 gathers the
reconstructions, scores them and writes the files.
"""

from __future__ import annotations

import os
import sys
import time
from typing import Dict, Optional

import numpy as np
import torch

from . import diffusion as dmod
from . import graphs
from . import metrics as M
from . import streams
from . import visualize as vz
from .checkpoint import load_parameters
from .config import resolve_in_channels
from .data.datasets import anomalous_dataset_from_args
from .data.pipeline import to_nchw, to_nhwc
from .device import DeviceLike, resolve_device
from .models.unet import unet_from_args
from .ops.noise import make_noise_sampler, sampler_from_args
from .parallel.mesh import Mesh, close_mesh, mesh_from_env, shard_sampler
from .schedule import schedule_from_args
from .streams import Stream

METRIC_NAMES = ("dice", "ssim", "iou", "precision", "recall", "fpr", "auc")
_USAGE = ("usage: python -m anoddpm_torch.detect [CHECKPOINT] <ARG_NUM> "
          "[metrics [VB=n] | validation | graph [DENSE] [STEP=s] [VOLS=n] "
          "[LB=b] | roc <ARG_NUM2>... [CE=<cfg>] [LESION=kind[:severity]] | "
          "methodA | methodB]\n       torchrun --nproc_per_node=N -m "
          "anoddpm_torch.detect [CHECKPOINT] <ARG_NUM> [metrics]")
_MODES = ("metrics", "validation", "graph", "roc", "methodA", "methodB")


def _is_main(mesh: Optional[Mesh]) -> bool:
    return mesh is None or mesh.is_main


def _wrap_pad(block: np.ndarray, n: int, source: np.ndarray) -> np.ndarray:
    """block grown to n rows with whole slices of `source` cycled from its
    start (np.resize), so that every batch keeps one shape."""
    pad = n - block.shape[0]
    if not pad:
        return block
    return np.concatenate([block, np.resize(source, (pad,) + source.shape[1:])])


def _sharded_recon(fb, x_np: np.ndarray, mesh: Optional[Mesh], device,
                   generator) -> np.ndarray:
    """fb(x, generator) over a global NHWC batch: this rank's rows on
    `device`, gathered back to the whole NHWC batch (numpy)."""
    local = x_np if mesh is None else mesh.shard_batch(x_np)
    with torch.inference_mode():
        recon = fb(to_nchw(local).to(device), generator)
    if mesh is not None:
        recon = mesh.gather_rows(recon)
    return to_nhwc(recon)


def _device_of(em) -> torch.device:
    return next(em.parameters()).device


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


def evaluate_anomaly_batch(em, sched, images, masks, generator,
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
    x = to_nchw(images).to(_device_of(em))
    with torch.inference_mode():
        recon = to_nhwc(fb(x, generator))
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
    anomalous slice (DDPM, or DDIM with args["sampler"] == "ddim"); writes
    metrics/args{n}.csv and returns the summary.

    `volume_batch` (or args["volume_batch"]) runs the slices of that many
    volumes as one batch; `args["recon_repeats"]` averages that many
    reconstructions before the square-error map.  The stream is seeded
    args' seed + 1; under `rng: "jax"` it is `key(seed + 1)`, split once
    per volume group and, with repeats, once more into one key per
    reconstruction (`anoddpm_tpu/detect.py:184-210`)."""
    device = resolve_device(device)
    if em is None:
        args, em, sched = _load_eval_model(root_dir, token, use_checkpoint,
                                           device)
    elif _device_of(em).type != device.type:
        raise ValueError(f"model on {_device_of(em)}, asked to run on {device}")
    sched = sched.to(device)
    # lambda = 200 against T = 1000 in the reference; clamp for short
    # schedules where 200 would index past T
    t_distance = min(t_distance, sched.num_timesteps)
    noise_sampler = sampler_from_args(args)
    d_set = anomalous_dataset_from_args(root_dir, args)
    n_volumes = len(d_set) if max_volumes is None else min(len(d_set),
                                                           max_volumes)

    if str(args.get("sampler") or "ddpm") == "ddim":
        ddim_steps = int(args.get("ddim_steps") or 25)
        ddim_eta = float(args.get("ddim_eta") or 0.0)

        def fb(x, g):
            return dmod.forward_backward_ddim(em, sched, x, t_distance,
                                              ddim_steps, g,
                                              noise_sampler=noise_sampler,
                                              eta=ddim_eta)
    else:
        def fb(x, g):
            return dmod.forward_backward(em, sched, x, t_distance, g,
                                         noise_sampler=noise_sampler)

    repeats = int(args.get("recon_repeats") or 1)
    if repeats > 1:
        one = fb

        def fb(x, g):
            return sum(one(x, s) for s in streams.of(g).split(repeats)) / repeats

    generator = streams.make(args, int(args.get("seed", 0) or 0) + 1, device)
    totals = {k: [] for k in METRIC_NAMES}
    start = time.time()
    vb = max(int(volume_batch or args.get("volume_batch") or 1), 1)
    for g0 in range(0, n_volumes, vb):
        group = [d_set[i] for i in range(g0, min(g0 + vb, n_volumes))]
        imgs = [np.asarray(s["image"]) for s in group]
        msks = [np.asarray(s["mask"]) for s in group]
        imgs = [a[None] if a.ndim == 3 else a for a in imgs]
        msks = [a[None] if a.ndim == 3 else a for a in msks]
        generator, sub = streams.of(generator).split()
        batch_out, _ = evaluate_anomaly_batch(
            em, sched, np.concatenate(imgs), np.concatenate(msks), sub,
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


def _load_anomalous_slices(root_dir: str, args, max_volumes):
    """Every anomalous slice of the first `max_volumes` volumes (all when
    None): (images, masks), each (S, H, W, C)."""
    d_set = anomalous_dataset_from_args(root_dir, args)
    n = len(d_set) if max_volumes is None else min(len(d_set), max_volumes)
    images, masks = [], []
    for i in range(n):
        sample = d_set[i]
        img, msk = np.asarray(sample["image"]), np.asarray(sample["mask"])
        images.append(img if img.ndim == 4 else img[None])
        masks.append(msk if msk.ndim == 4 else msk[None])
    return np.concatenate(images), np.concatenate(masks)


def sharded_anomalous_metrics(args, em, sched, mesh: Optional[Mesh],
                              root_dir: str = ".", t_distance: int = 200,
                              max_volumes: Optional[int] = None,
                              chunk_per_device: int = 16):
    """The headline metrics over the ranks of `mesh` (one process when
    None): every anomalous slice of the set, in chunks of
    `chunk_per_device` x world_size slices (the last wrap-padded to that
    size), each chunk split over the ranks and reconstructed by
    `forward_backward` at lambda = `t_distance` (clamped to T) from a
    generator seeded 17 + the chunk's first slice on every rank (under
    `rng: "jax"` the key key(17 + that slice), as in JAX).  Rank 0
    gathers the reconstructions, scores them with
    `metrics.batched_anomaly_metrics`, writes metrics/args{n}.csv and
    returns the summary; the other ranks return None."""
    device = _device_of(em)
    sched = sched.to(device)
    t_distance = min(t_distance, sched.num_timesteps)
    sampler = shard_sampler(sampler_from_args(args), mesh)
    images, masks = _load_anomalous_slices(root_dir, args, max_volumes)
    n_slices = images.shape[0]
    w = 1 if mesh is None else mesh.world_size
    chunk = min(w * max(chunk_per_device, 1), n_slices + (-n_slices) % w)

    def fb(x, g):
        return dmod.forward_backward(em, sched, x, t_distance, g,
                                     noise_sampler=sampler)

    recons = []
    for start in range(0, n_slices, chunk):
        block = images[start:start + chunk]
        got = block.shape[0]
        generator = streams.make(args, 17 + start, device)
        recon = _sharded_recon(fb, _wrap_pad(block, chunk, images), mesh,
                               device, generator)
        recons.append(recon[:got])
    if not _is_main(mesh):
        return None
    recon = np.concatenate(recons)
    per_slice = M.batched_anomaly_metrics(images, recon, masks)
    summary = {}
    for k, v in per_slice.items():
        summary[k] = float(np.mean(v))
        summary[k + "_std"] = float(np.std(v))
    _write_metrics_csv(root_dir, args["arg_num"], summary)
    return summary


def _eval_inputs(args, root_dir, token, use_checkpoint, device):
    """(args, em, sched) from `args` when it is that triple, else the
    checkpoint of `token`."""
    if args is None:
        return _load_eval_model(root_dir, token, use_checkpoint,
                                resolve_device(device))
    args, em, sched = args
    return args, em, sched.to(_device_of(em))


def _mean_recon(em, sched, x, t_distance, generator, sampler, avg):
    """(the stream after the draws, (avg, B, H, W, C) reconstructions of x
    by `forward_backward`): `sampler`'s noise for the q-jump, Gaussian
    noise for the reverse steps; the stream split once per
    reconstruction, as the JAX package's methods A and B split it."""
    recons = []
    with torch.inference_mode():
        for _ in range(avg):
            generator, sub = streams.of(generator).split()
            recons.append(to_nhwc(dmod.forward_backward(
                em, sched, x, t_distance, sub, noise_sampler=sampler,
                denoise_sampler=make_noise_sampler("gauss"))))
    return generator, np.stack(recons)


def detection_A(args, em, sched, x_0, mask, file_id, root_dir: str = ".",
                total_avg: int = 2, generator: Optional[Stream] = None):
    """Method A: simplex frequency 2^7 .. 2^1 times lambda in {50, 100, ...,
    < 0.6 T}; the mean of `total_avg` reconstructions; one comparison grid
    per pair, diffusion-videos/ARGS={n}/Anomalous/{file_id}/A/
    freq={i}-t={lambda}.png.  The q-jump goes to lambda - 1, as in
    `forward_backward` (the reference's method A jumps to lambda; the JAX
    package normalises it so, PARITY.md); the reverse noise is Gaussian.
    The stream is seeded 2 unless given (`key(2)` under `rng: "jax"`)."""
    device = _device_of(em)
    if generator is None:
        generator = streams.make(args, 2, device)
    out_dir = os.path.join(root_dir, "diffusion-videos",
                           f"ARGS={args['arg_num']}", "Anomalous",
                           str(file_id), "A")
    x_np, mask = np.asarray(x_0, np.float32), np.asarray(mask)
    x = to_nchw(x_np).to(device)
    for i in range(7, 0, -1):
        sampler = make_noise_sampler("simplex", frequency=float(2 ** i))
        for t_distance in range(50, int(int(args["T"]) * 0.6), 50):
            generator, output = _mean_recon(em, sched, x, t_distance,
                                            generator, sampler, total_avg)
            output_mean = output.mean(axis=0)
            mse = ((output_mean - x_np) ** 2 * 2) - 1
            mse_threshold = ((mse > 0).astype(np.float32) * 2) - 1
            panels = np.concatenate([x_np, output[:3, 0], output_mean, mse,
                                     mse_threshold, mask], axis=0)
            vz.save_grid_png(os.path.join(out_dir,
                                          f"freq={i}-t={t_distance}.png"),
                             panels, row_size=4)


def detection_B(args, em, sched, x_0, mask, file_id,
                denoise_fn: str = "octave", root_dir: str = ".",
                total_avg: int = 5, generator: Optional[Stream] = None):
    """Method B ("octave": simplex, 6 octaves at frequency 64, lambda <
    0.6 T) or C ("gauss", lambda < 0.8 T): per lambda in {50, 100, ...} the
    mean of `total_avg` reconstructions, a heatmap figure
    diffusion-videos/ARGS={n}/Anomalous/{file_id}/{denoise_fn}/
    heatmap-t={lambda}.png, and its Dice; returns the Dice per lambda.
    The stream is seeded 3 unless given (`key(3)` under `rng: "jax"`)."""
    device = _device_of(em)
    if generator is None:
        generator = streams.make(args, 3, device)
    out_dir = os.path.join(root_dir, "diffusion-videos",
                           f"ARGS={args['arg_num']}", "Anomalous",
                           str(file_id), denoise_fn)
    if denoise_fn == "octave":
        end = int(int(args["T"]) * 0.6)
        sampler = make_noise_sampler("simplex", octaves=6, persistence=0.8,
                                     frequency=64)
    else:
        end = int(int(args["T"]) * 0.8)
        sampler = make_noise_sampler("gauss")
    x_np, mask = np.asarray(x_0, np.float32), np.asarray(mask)
    x = to_nchw(x_np).to(device)
    dice_scores = []
    for t_distance in range(50, end, 50):
        generator, output = _mean_recon(em, sched, x, t_distance, generator,
                                        sampler, total_avg)
        output_mean = output.mean(axis=0)
        vz.heatmap_figure(x_np, output_mean, mask,
                          os.path.join(out_dir, f"heatmap-t={t_distance}.png"))
        dice_scores.append(M.dice_coeff(x_np, output_mean, mask))
    return dice_scores


def detection_A_fixedT(args, em, sched, x_0, mask, end_freq: int = 6,
                       t_distance: int = 250,
                       generator: Optional[Stream] = None) -> np.ndarray:
    """Fixed lambda = 250 at simplex frequency 2^1 .. 2^end_freq (forward and
    reverse noise): per frequency the rows x_0, x_noised, recon, square
    error, thresholded map, mask, stacked into one NHWC array.  The stream
    is seeded 4 unless given (`key(4)` under `rng: "jax"`), and split in
    three per frequency: the next stream, the q-jump's, the chain's."""
    device = _device_of(em)
    if generator is None:
        generator = streams.make(args, 4, device)
    x_np, mask = np.asarray(x_0, np.float32), np.asarray(mask)
    x = to_nchw(x_np).to(device)
    t_batch = torch.full((x.shape[0],), t_distance - 1, dtype=torch.int64,
                         device=device)
    rows = []
    for i in range(1, end_freq + 1):
        sampler = make_noise_sampler("simplex", frequency=float(2 ** i))
        generator, k_fwd, k_rev = streams.of(generator).split(3)
        with torch.inference_mode():
            x_noised = dmod.sample_q(sched, x, t_batch,
                                     sampler(x.shape, t_batch, k_fwd))
            recon = to_nhwc(dmod.denoise_chain(em, sched, x_noised,
                                                 t_distance, k_rev,
                                                 noise_sampler=sampler))
        mse = ((x_np - recon) ** 2 * 2) - 1
        thresh = ((mse > 0).astype(np.float32) * 2) - 1
        rows.append(np.concatenate([x_np, to_nhwc(x_noised), recon, mse,
                                    thresh, mask], axis=0))
    return np.concatenate(rows, axis=0)


def anomalous_validation(args=None, root_dir: str = ".",
                         token: Optional[str] = None,
                         max_volumes: Optional[int] = None,
                         max_slices: int = 4,
                         detection_avg: int = 3,
                         use_checkpoint: bool = False,
                         device: DeviceLike = None):
    """Per-slice videos and heatmaps, then the detection sweeps by noise
    kind, for `max_slices` slices of every anomalous volume (or
    `max_volumes`).  `args` is an (args, em, sched) triple, or None to load
    `token`'s checkpoint.

    Per slice: a timestep drawn in [0.3, 0.8) x sample_distance for gauss
    configs, [0.1, 0.6) otherwise, quantised to a 50-step grid (1 below a
    sample_distance of 100) and clamped to [quantum, T]; a "whole"-sequence
    `forward_backward` -> diffusion-videos/ARGS={n}/Anomalous/{volume}/
    {slice}/t={t}.mp4 (or .gif) and the heatmap t={t}.png beside it; then
    detection_B ("gauss" for gauss configs, else "octave"), and for
    simplex_randParam detection_A too.  Returns the heatmap Dice per
    slice.  The stream is seeded 5 (`key(5)` under `rng: "jax"`) and split
    in five per slice: the next stream, t's, the sequence's, method B's
    and method A's (`anoddpm_tpu/detect.py:436-437`)."""
    args, em, sched = _eval_inputs(args, root_dir, token, use_checkpoint,
                                   device)
    device = _device_of(em)
    noise_sampler = sampler_from_args(args)
    noise_kind = str(args.get("noise_fn") or "simplex")
    d_set = anomalous_dataset_from_args(root_dir, args)
    generator = streams.make(args, 5, device)
    n = len(d_set) if max_volumes is None else min(len(d_set), max_volumes)
    sample_distance = int(args.get("sample_distance") or sched.num_timesteps)
    lo, hi = ((0.3, 0.8) if noise_kind == "gauss" else (0.1, 0.6))
    quantum = 50 if sample_distance >= 100 else 1
    t_lo = int(sample_distance * lo)
    t_hi = max(int(sample_distance * hi), t_lo + 1)
    dice_data = []
    start = time.time()
    for i in range(n):
        sample = d_set[i]
        images = np.asarray(sample["image"])
        masks = np.asarray(sample["mask"])
        if images.ndim == 3:
            images, masks = images[None], masks[None]
        file_id = os.path.basename(str(sample["filenames"]))
        slice_ids = list(sample.get("slices", range(images.shape[0])))
        vol_dir = os.path.join(root_dir, "diffusion-videos",
                               f"ARGS={args['arg_num']}", "Anomalous", file_id)
        for s in range(min(images.shape[0], max_slices)):
            x_np, mask = images[s:s + 1], masks[s:s + 1]
            generator, k_t, k_seq, k_b, k_a = streams.of(generator).split(5)
            timestep = t_lo + int(streams.of(k_t).randint((), t_hi - t_lo))
            timestep = round(timestep / quantum) * quantum
            timestep = max(quantum, min(timestep, sched.num_timesteps))
            with torch.inference_mode():
                recon, frames = dmod.forward_backward_sequence(
                    em, sched, to_nchw(x_np).to(device), timestep, k_seq,
                    noise_sampler=noise_sampler, see_whole_sequence="whole")
            recon, frames = to_nhwc(recon), to_nhwc(frames)
            out_name = os.path.join(vol_dir, str(slice_ids[s]), f"t={timestep}")
            vz.save_video(out_name + ".mp4", list(frames))
            vz.heatmap_figure(x_np, recon, mask, out_name + ".png")
            dice_data.append(M.dice_coeff(x_np, recon, mask))
            slice_tag = f"{file_id}-{slice_ids[s]}"
            if noise_kind == "simplex_randParam":
                detection_A(args, em, sched, x_np, mask, slice_tag,
                            root_dir=root_dir, total_avg=detection_avg,
                            generator=k_a)
            detection_B(args, em, sched, x_np, mask, slice_tag,
                        denoise_fn=("gauss" if noise_kind == "gauss"
                                    else "octave"),
                        root_dir=root_dir, total_avg=detection_avg,
                        generator=k_b)
        print(f"volume {file_id} [{i + 1}/{n}] done, "
              f"elapsed {time.time() - start:.0f}s", flush=True)
    return dice_data


def _auto_lambda_batch(img_size: int) -> int:
    """graph_data's default lambda batch: 32 at 256^2, scaled inversely with
    the pixel count and clamped to [8, 128]."""
    scale = (256 * 256) / float(max(int(img_size), 1) ** 2)
    return int(max(8, min(128, 32 * scale)))


def graph_data(args=None, root_dir: str = ".", token: Optional[str] = None,
               lambdas=None, max_volumes: int = 4,
               use_checkpoint: bool = False, dense: bool = False,
               lambda_batch: Optional[int] = None, slice_index: int = 1,
               lambda_step: int = 1, mesh: Optional[Mesh] = None,
               device: DeviceLike = None):
    """Per-lambda metric curves on slice `slice_index` of up to
    `max_volumes` volumes: metrics/ARGS={n}/{volume}.csv (columns
    timestep,Dice,SSIM,IOU,Precision,Recall,FPR) with its plot {volume}.png,
    the pooled means metrics/args{n}-lambda.csv (t,dice,ssim,iou,auc) and
    final-outputs/args{n}-dice-lambda.png.  The grid is every lambda in
    [0, T) with `dense` (every `lambda_step`-th), else {50, 100, ...}.

    The lambda grid rides the batch axis: `lambda_batch` copies of the slice
    (default `_auto_lambda_batch` of the image size), each at its own
    lambda, go through one masked `forward_backward_batched_lambda` chain of
    max(lambdas) steps; the last chunk is padded with its first lambda.
    Under a `mesh` the lambda batch (rounded up to a multiple of the world
    size) is split over the ranks, and rank 0 scores and writes.  The
    stream is seeded 11 (`key(11)` under `rng: "jax"`) and split once per
    chunk; every rank splits alike and draws the noise of the whole lambda
    batch.  Returns the pooled rows (None on the other ranks)."""
    if mesh is not None and args is None:
        device = mesh.device
    args, em, sched = _eval_inputs(args, root_dir, token, use_checkpoint,
                                   device)
    device = _device_of(em)
    noise_sampler = shard_sampler(sampler_from_args(args), mesh)
    main_rank = _is_main(mesh)
    if lambdas is None:
        lambdas = (range(0, sched.num_timesteps, lambda_step) if dense
                   else range(50, sched.num_timesteps, 50))
    lambdas = [int(t) for t in lambdas]
    if not lambdas:
        print("graph_data: empty lambda grid (T too short for the 50-step "
              "grid), nothing to sweep", flush=True)
        return []
    max_t = max(lambdas)
    if lambda_batch is None:
        img = args.get("img_size") or (256, 256)
        img = img[0] if isinstance(img, (tuple, list)) else int(img)
        lambda_batch = _auto_lambda_batch(img)
    lambda_batch = min(lambda_batch, len(lambdas))
    if mesh is not None:
        lambda_batch = -(-lambda_batch // mesh.world_size) * mesh.world_size
    rows_of = slice(None) if mesh is None else mesh.rows(lambda_batch)
    local_batch = lambda_batch // (1 if mesh is None else mesh.world_size)
    d_set = anomalous_dataset_from_args(root_dir, args)
    n = min(len(d_set), max_volumes)
    vol_dir = os.path.join(root_dir, "metrics", f"ARGS={args['arg_num']}")
    if main_rank:
        os.makedirs(vol_dir, exist_ok=True)
    generator = streams.make(args, 11, device)
    per_volume = []
    for i in range(n):
        sample = d_set[i]
        img = sample["image"]
        img = img if img.ndim == 4 else img[None]
        msk = sample["mask"]
        msk = msk if msk.ndim == 4 else msk[None]
        s = min(slice_index, img.shape[0] - 1)
        x0 = np.asarray(img[s:s + 1])
        mask = np.asarray(msk[s:s + 1])
        vol_name = os.path.basename(str(sample.get("filenames", i)))
        x_rep = to_nchw(x0).to(device).repeat(local_batch, 1, 1, 1)
        curves = {m: np.empty(len(lambdas)) for m in METRIC_NAMES}
        for begin in range(0, len(lambdas), lambda_batch):
            lam_chunk = lambdas[begin:begin + lambda_batch]
            pad = lambda_batch - len(lam_chunk)
            lamv = torch.tensor((lam_chunk + lam_chunk[:1] * pad)[rows_of],
                                dtype=torch.int64, device=device)
            generator, sub = streams.of(generator).split()
            with torch.inference_mode():
                recon = dmod.forward_backward_batched_lambda(
                    em, sched, x_rep, lamv, max_t, sub,
                    noise_sampler=noise_sampler)
            recon = to_nhwc(recon if mesh is None else mesh.gather_rows(recon))
            if not main_rank:
                continue
            got = len(lam_chunk)
            batch_m = M.batched_anomaly_metrics(
                np.broadcast_to(x0, (got,) + x0.shape[1:]), recon[:got],
                np.broadcast_to(mask, (got,) + mask.shape[1:]))
            for m in METRIC_NAMES:
                curves[m][begin:begin + got] = batch_m[m]
        if not main_rank:
            continue
        with open(os.path.join(vol_dir, f"{vol_name}.csv"), "w") as f:
            f.write("timestep,Dice,SSIM,IOU,Precision,Recall,FPR\n")
            for j, t in enumerate(lambdas):
                f.write(f"{t:04}," + ",".join(
                    f"{curves[m][j]:.4f}" for m in METRIC_NAMES[:-1]) + "\n")
        _per_volume_lambda_plot(lambdas, curves,
                                os.path.join(vol_dir, f"{vol_name}.png"))
        per_volume.append(curves)
        print(f"[{i + 1}/{n}] {vol_name}: peak dice "
              f"{curves['dice'].max():.4f} at lambda="
              f"{lambdas[int(curves['dice'].argmax())]}", flush=True)
    if not main_rank:
        return None

    pooled = ("dice", "ssim", "iou", "auc")
    rows = [{"t": t, **{m: float(np.mean([c[m][j] for c in per_volume]))
                        for m in pooled}}
            for j, t in enumerate(lambdas)]
    csv_path = os.path.join(root_dir, "metrics",
                            f"args{args['arg_num']}-lambda.csv")
    with open(csv_path, "w") as f:
        f.write("t," + ",".join(pooled) + "\n")
        for r in rows:
            f.write(f"{r['t']}," + ",".join(repr(r[m]) for m in pooled) + "\n")
    graphs.graph_dice_comparison(
        [csv_path], [f"args{args['arg_num']}"],
        os.path.join(root_dir, "final-outputs",
                     f"args{args['arg_num']}-dice-lambda.png"))
    return rows


def _per_volume_lambda_plot(lambdas, curves, path):
    """Dice, IOU, precision and recall against lambda, y in [0, 1]."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    for name, label in (("dice", "dice"), ("iou", "IOU"),
                        ("precision", "precision"), ("recall", "recall")):
        plt.plot(lambdas, curves[name], label=label)
    plt.legend(loc="upper right")
    plt.gca().set_ylim([0, 1])
    plt.savefig(path)
    plt.clf()


def roc_data(tokens, labels=None, root_dir: str = ".",
             t_distance: int = 200, max_volumes: Optional[int] = None,
             use_checkpoint: bool = False, ce_token: Optional[str] = None,
             ce_train_steps: int = 2000, args_override=None,
             mesh: Optional[Mesh] = None, device: DeviceLike = None):
    """The pixel ROC of each checkpoint in `tokens` over its anomalous set
    (lambda = `t_distance`, clamped to T; the raw square error as the
    score): metrics/roc-comparison.csv (<label>_fpr, <label>_tpr columns,
    downsampled) and final-outputs/roc-comparison.png; returns {label:
    (fpr, tpr)}.  `args_override` entries are set in every method's args
    (e.g. {"lesion_kind": "diffuse"}).

    `ce_token` adds the curve "context-encoder": the baseline
    (`baselines.py`) trained for `ce_train_steps` on that config's healthy
    set and scored on its anomalous set (metrics/args{n}-ce.csv).  Under a
    `mesh` each volume's slices (wrap-padded to a multiple of the world
    size) are split over the ranks; rank 0 trains the context encoder,
    scores, writes and returns the curves, the other ranks return None.
    The stream is seeded 13 (`key(13)` under `rng: "jax"`) and split once
    per volume."""
    device = mesh.device if mesh is not None else resolve_device(device)
    main_rank = _is_main(mesh)
    labels = labels or [f"args{t}" for t in tokens]
    curves = {}
    for token, label in zip(tokens, labels):
        args, em, sched = _load_eval_model(root_dir, token, use_checkpoint,
                                           device)
        for k, v in (args_override or {}).items():
            args[k] = v
        noise_sampler = shard_sampler(sampler_from_args(args), mesh)
        td = min(t_distance, sched.num_timesteps)
        d_set = anomalous_dataset_from_args(root_dir, args)
        n = len(d_set) if max_volumes is None else min(len(d_set), max_volumes)
        generator = streams.make(args, 13, device)

        def fb(x, g):
            return dmod.forward_backward(em, sched, x, td, g,
                                         noise_sampler=noise_sampler)

        all_scores, all_labels = [], []
        for i in range(n):
            sample = d_set[i]
            images = np.asarray(sample["image"])
            masks = np.asarray(sample["mask"])
            if images.ndim == 3:
                images, masks = images[None], masks[None]
            w = 1 if mesh is None else mesh.world_size
            block = _wrap_pad(images, images.shape[0] + (-images.shape[0]) % w,
                              images)
            generator, sub = streams.of(generator).split()
            recon = _sharded_recon(fb, block, mesh, device,
                                   sub)[:images.shape[0]]
            all_scores.append(((images - recon) ** 2).reshape(-1))
            all_labels.append(masks.reshape(-1))
        if main_rank:
            fpr, tpr, _ = M.roc_curve(np.concatenate(all_labels),
                                      np.concatenate(all_scores))
            curves[label] = (fpr, tpr)
            print(f"{label}: AUC={M.auc(fpr, tpr):.4f}", flush=True)
    if not main_rank:
        return None

    if ce_token is not None:
        from . import baselines
        from .config import load_args
        ce_args = load_args(ce_token,
                            config_dir=os.path.join(root_dir, "configs"))
        for k, v in (args_override or {}).items():
            ce_args[k] = v
        ce_model = baselines.train_context_encoder(
            ce_args, root_dir=root_dir, steps=ce_train_steps, device=device)
        _, (ce_fpr, ce_tpr, _) = baselines.ce_anomalous_metrics(
            ce_model, ce_args, root_dir=root_dir, max_volumes=max_volumes)
        curves["context-encoder"] = (ce_fpr, ce_tpr)
        print(f"context-encoder: AUC={M.auc(ce_fpr, ce_tpr):.4f}", flush=True)

    graphs.make_roc_csv(curves, os.path.join(root_dir, "metrics",
                                             "roc-comparison.csv"))
    _roc_plot(curves, os.path.join(root_dir, "final-outputs",
                                   "roc-comparison.png"))
    return curves


def _roc_plot(curves, path):
    """The ROC curves with their AUCs in the legend, and the chance line."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    plt.figure(dpi=150)
    for label, (fpr, tpr) in curves.items():
        plt.plot(fpr, tpr, label=f"{label} (AUC={M.auc(fpr, tpr):.3f})")
    plt.plot([0, 1], [0, 1], "k--", alpha=0.3)
    plt.xlabel("FPR")
    plt.ylabel("TPR")
    plt.legend()
    os.makedirs(os.path.dirname(path), exist_ok=True)
    plt.savefig(path, bbox_inches="tight")
    plt.close("all")


def _graph_options(rest) -> dict:
    """graph's trailing tokens: DENSE, STEP=s, VOLS=n, LB=b."""
    kw = {}
    for a in rest:
        if a == "DENSE":
            kw["dense"] = True
        elif a.startswith("STEP="):
            kw["lambda_step"] = int(a[5:])
        elif a.startswith("VOLS="):
            kw["max_volumes"] = int(a[5:])
        elif a.startswith("LB="):
            kw["lambda_batch"] = int(a[3:])
        else:
            raise SystemExit(_USAGE)
    return kw


def _roc_options(rest):
    """roc's trailing tokens: more checkpoints, CE=cfg, LESION=kind[:sev]."""
    tokens, ce_token, override = [], None, None
    for a in rest:
        if a.startswith("CE="):
            ce_token = a[3:]
        elif a.startswith("LESION="):
            kind, _, sev = a[7:].partition(":")
            override = {"lesion_kind": kind}
            if sev:
                override["lesion_severity"] = float(sev)
        else:
            tokens.append(a)
    return tokens, ce_token, override


def main(argv=None, device: DeviceLike = None):
    argv = list(sys.argv[1:] if argv is None else argv)
    use_checkpoint = bool(argv) and argv[0] == "CHECKPOINT"
    if use_checkpoint:
        argv = argv[1:]
    if not argv:
        raise SystemExit(_USAGE)
    token, rest = argv[0], argv[1:]
    mode = rest.pop(0) if rest and rest[0] in _MODES else "metrics"
    if mode in ("methodA", "methodB", "validation") and rest:
        raise SystemExit(_USAGE)
    if mode in ("methodA", "methodB"):
        args, em, sched = _load_eval_model(".", token, use_checkpoint, device)
        sample = anomalous_dataset_from_args(".", args)[0]
        x, mask = sample["image"][:1], sample["mask"][:1]
        fid = os.path.basename(str(sample["filenames"]))
        if mode == "methodA":
            detection_A(args, em, sched, x, mask, fid)
        else:
            kind = "gauss" if str(args.get("noise_fn")) == "gauss" else "octave"
            dice = detection_B(args, em, sched, x, mask, fid, denoise_fn=kind)
            print("detection_B dice per lambda:", [round(d, 4) for d in dice])
    elif mode == "validation":
        anomalous_validation(token=token, use_checkpoint=use_checkpoint,
                             device=device)
    elif mode == "graph":
        graph_data(token=token, use_checkpoint=use_checkpoint, device=device,
                   **_graph_options(rest))
    elif mode == "roc":
        tokens, ce_token, override = _roc_options(rest)
        roc_data([token] + tokens, use_checkpoint=use_checkpoint,
                 ce_token=ce_token, args_override=override, device=device)
    else:
        vb = None
        for a in rest:
            if not a.startswith("VB="):
                raise SystemExit(_USAGE)
            vb = int(a[3:])
        mesh = mesh_from_env(device)
        if mesh is None:
            anomalous_metric_calculation(token=token,
                                         use_checkpoint=use_checkpoint,
                                         volume_batch=vb, device=device)
            return
        try:
            args, em, sched = _load_eval_model(".", token, use_checkpoint,
                                               mesh.device)
            summary = sharded_anomalous_metrics(args, em, sched, mesh)
            if mesh.is_main:
                print(summary)
        finally:
            close_mesh(mesh)


if __name__ == "__main__":
    main()