"""Test-set evaluation suite (counterpart of `anoddpm_tpu/evaluation.py:
27-132`, the reference's evaluation.py:90-186 `testing`).

For a trained model: with `save_videos`, "half"-sequence partial-diffusion
videos at lambda = 100, 200, ... < sample_distance
(diffusion-videos/ARGS={n}/test-set/t={lambda}.mp4, or .gif); total and
prior VLB statistics with vb, x0-MSE and eps-MSE at t = 200; and the PSNR
of reconstructions from T/2; printed, returned as a dict and written to
metrics/args{n}-test.json.

CLI: ``python -m anoddpm_torch.evaluation <ARG_NUM>`` evaluates the final
checkpoint of a config on its test set, on the card.
"""

from __future__ import annotations

import json
import os
import sys
from typing import Dict, Optional

import numpy as np
import torch

from . import diffusion as dm
from . import metrics as M
from . import visualize as vz
from .data.pipeline import to_nchw, to_nhwc
from .device import DeviceLike
from .ops.noise import NoiseSampler, gaussian_noise
from .schedule import Schedule


def testing(test_iter, model, sched: Schedule, args,
            noise_sampler: NoiseSampler = gaussian_noise,
            generator: Optional[torch.Generator] = None, root_dir: str = ".",
            n_images: int = 40, save_videos: bool = False) -> Dict[str, float]:
    """Evaluate `model` (the EMA UNet, on its device) on the test set.

    `test_iter` must be infinite (cycling), yielding {"image": (B, H, W, C)}
    numpy batches: the videos take one batch each, then the VLB pass and
    the PSNR pass each draw batches until they have seen `n_images`
    images."""
    device = next(model.parameters()).device
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    arg_num = args["arg_num"]
    t_half = sched.num_timesteps // 2
    was_training = model.training
    model.eval()

    def next_batch():
        return to_nchw(next(test_iter)["image"]).to(device)

    total_vlbs, prior_vlbs, vb200, x0mse200, mse200 = [], [], [], [], []
    psnrs = []
    # the reference reads batch element 0 at position 199 of the
    # descending-t stack; clamped for short schedules.  vlb_batch_mean
    # widens the t = 200 statistics to the batch mean.
    idx = min(199, sched.num_timesteps - 1)
    sel = ((lambda a: float(a[:, idx].mean())) if args.get("vlb_batch_mean")
           else (lambda a: float(a[0, idx])))
    sample_distance = int(args.get("sample_distance") or sched.num_timesteps)
    video_dir = os.path.join(root_dir, "diffusion-videos", f"ARGS={arg_num}",
                             "test-set")
    with torch.inference_mode():
        for lam in range(100, sample_distance, 100) if save_videos else ():
            x = next_batch()
            _, frames = dm.forward_backward_sequence(
                model, sched, x, lam, generator, noise_sampler=noise_sampler,
                see_whole_sequence="half")
            vz.save_video(os.path.join(video_dir, f"t={lam}.mp4"),
                          list(to_nhwc(frames)),
                          row_size=min(5, x.shape[0]))
        seen = 0
        while seen < n_images:
            x = next_batch()
            out = dm.calc_total_vlb(model, sched, x, generator)
            total_vlbs.append(float(out["total_vlb"].mean()))
            prior_vlbs.append(float(out["prior_vlb"].mean()))
            vb200.append(sel(out["vb"]))
            x0mse200.append(sel(out["x_0_mse"]))
            mse200.append(sel(out["mse"]))
            seen += x.shape[0]
        seen = 0
        while seen < n_images:
            x = next_batch()
            recon = dm.forward_backward(model, sched, x, t_half, generator,
                                        noise_sampler=noise_sampler)
            psnrs.append(M.psnr(recon.cpu().numpy(), x.cpu().numpy()))
            seen += x.shape[0]
    model.train(was_training)

    results = {
        "total_vlb": float(np.mean(total_vlbs)),
        "total_vlb_std": float(np.std(total_vlbs)),
        "prior_vlb": float(np.mean(prior_vlbs)),
        "prior_vlb_std": float(np.std(prior_vlbs)),
        "vb_at_200": float(np.mean(vb200)),
        "x_0_mse_at_200": float(np.mean(x0mse200)),
        "mse_at_200": float(np.mean(mse200)),
        "psnr": float(np.mean(psnrs)),
        "psnr_std": float(np.std(psnrs)),
    }
    print(f"Test set total VLB: {results['total_vlb']} +- {results['total_vlb_std']}")
    print(f"Test set prior VLB: {results['prior_vlb']} +- {results['prior_vlb_std']}")
    print(f"Test set vb @ t=200: {results['vb_at_200']}")
    print(f"Test set x_0_mse @ t=200: {results['x_0_mse_at_200']}")
    print(f"Test set mse @ t=200: {results['mse_at_200']}")
    print(f"Test set PSNR: {results['psnr']} +- {results['psnr_std']}")

    metrics_dir = os.path.join(root_dir, "metrics")
    os.makedirs(metrics_dir, exist_ok=True)
    with open(os.path.join(metrics_dir, f"args{arg_num}-test.json"), "w") as f:
        json.dump(results, f, indent=1)
    return results


def main(argv=None, device: DeviceLike = None):
    """``python -m anoddpm_torch.evaluation <ARG_NUM>``: the test-set suite
    on the final checkpoint of configs/args{N}.json, with videos when the
    config sets save_vids."""
    from .data.datasets import dataset_from_args
    from .data.pipeline import batch_iterator
    from .detect import _load_eval_model
    from .ops.noise import sampler_from_args

    argv = list(sys.argv[1:] if argv is None else argv)
    if len(argv) != 1:
        raise SystemExit("usage: python -m anoddpm_torch.evaluation <ARG_NUM>")
    args, model, sched = _load_eval_model(".", argv[0], device=device)
    test_ds = dataset_from_args(".", args, train=False)
    it = batch_iterator(test_ds, int(args["Batch_Size"]), shuffle=True, seed=1)
    return testing(it, model, sched, args, noise_sampler=sampler_from_args(args),
                   save_videos=bool(args.get("save_vids")))


if __name__ == "__main__":
    main()
