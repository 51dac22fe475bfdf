"""The seed-to-seed spread of both packages' training at 32^2 on the CPU:
``python scripts/torch_f3_cpu_spread.py [--seeds N] [--epochs E] [--out PATH]``.

Each package trains seeds 0..N-1 (5 by default) of one small config of
the s2d64 recipe's layout, through its own trainer and its own draws: 32^2
images through a space-to-depth of 2 into a UNet of base 32, mults (1, 2),
attention at 16, 2 heads, bf16 compute, simplex noise, linear T = 100 with
train_start below 80, batch 8, AdamW 1e-4 after the global-norm clip, 16
steps an epoch for epochs 0..E (24 by default: 400 steps), the epoch-0 VLB
sweep, no test-set suite.  The JAX package trains in a subprocess
(``python -m anoddpm_tpu.train``, JAX_PLATFORMS=cpu), the port in this
process (`anoddpm_torch.train.train`, device "cpu"); the synthetic set and
its batch order are the same for both.

Every trained model (its parameters, read by the port's checkpoint reader,
which reads both packages' checkpoints) is then scored by one evaluator,
the port's UNet in bf16, on inputs that are the same for every model:

- the l2 epsilon loss on a fixed held-out batch (8 test-set phantoms at
  fixed t, with one fixed simplex noise tensor);
- a fixed injected detection chain: 8 anomalous slices (2 volumes) jumped
  to lambda = 20 and denoised by 20 DDPM steps, every draw read from one
  noise bank, scored by Dice and AUC (`metrics.batched_anomaly_metrics`).

The parameters are scored, not the EMA: at 0.9999 the EMA of 400 steps
keeps 96% of the init.  Per package: each metric per seed, and per metric
`campaigns.band.compare` (the port against the JAX package: Welch's t and
the F-test of the variances).  The JSON goes to --out
(results/torch_f3_cpu_spread.json).  It runs on the CPU only.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from anoddpm_torch import diffusion as dm  # noqa: E402
from anoddpm_torch import metrics as M  # noqa: E402
from anoddpm_torch.campaigns._results import save_results  # noqa: E402
from anoddpm_torch.campaigns.band import compare  # noqa: E402
from anoddpm_torch.checkpoint import load_checkpoint  # noqa: E402
from anoddpm_torch.config import load_args  # noqa: E402
from anoddpm_torch.data.datasets import (SyntheticAnomalyDataset,  # noqa: E402
                                         SyntheticMRIDataset)
from anoddpm_torch.data.pipeline import to_nchw, to_nhwc  # noqa: E402
from anoddpm_torch.models.unet import unet_from_args  # noqa: E402
from anoddpm_torch.ops.noise import make_noise_sampler  # noqa: E402
from anoddpm_torch.schedule import schedule_from_args  # noqa: E402
from anoddpm_torch.train import train  # noqa: E402

OUT = "results/torch_f3_cpu_spread.json"
CONFIG = {"img_size": [32, 32], "Batch_Size": 8, "EPOCHS": 24, "T": 100,
          "base_channels": 32, "channel_mults": "1,2", "loss-type": "l2",
          "loss_weight": "none", "train_start": True, "lr": 1e-4,
          "random_slice": True, "sample_distance": 80, "weight_decay": 0.0,
          "save_imgs": False, "save_vids": False, "dropout": 0,
          "attention_resolutions": "16", "num_heads": 2,
          "num_head_channels": -1, "noise_fn": "simplex",
          "dataset": "synthetic", "iters_per_epoch": 16,
          "checkpoint_every": 1000, "compute_dtype": "bfloat16",
          "beta_schedule": "linear", "space_to_depth": 2,
          "skip_test_eval": True}
HELD_OUT = 8          # test-set phantoms in the held-out batch
LAMBDA = 20           # the detection chain's depth (200 of T = 1000 scaled)
VOLUMES = 2           # anomalous volumes of 4 slices
METRICS = ("heldout_loss", "dice", "auc")


def write_config(root: str, token: str, seed: int, epochs: int) -> None:
    os.makedirs(os.path.join(root, "configs"), exist_ok=True)
    with open(os.path.join(root, "configs", f"args{token}.json"), "w") as f:
        json.dump({**CONFIG, "EPOCHS": epochs, "seed": seed}, f)


def train_jax(root: str, token: str) -> float:
    """The JAX package's trainer on `token` in a subprocess; its seconds."""
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "PYTHONPATH": ROOT + os.pathsep + os.environ.get("PYTHONPATH", "")}
    t0 = time.time()
    proc = subprocess.run([sys.executable, "-m", "anoddpm_tpu.train", token],
                          cwd=root, env=env, capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"the JAX trainer failed on {token}:\n"
                           + proc.stdout[-2000:] + proc.stderr[-4000:])
    return time.time() - t0


def train_port(root: str, token: str) -> float:
    t0 = time.time()
    train(load_args(token, config_dir=os.path.join(root, "configs")),
          root_dir=root, device="cpu")
    return time.time() - t0


def fixed_inputs(args):
    """The held-out batch with its t and noise, and the anomalous slices
    with their masks and noise bank: the same for every model."""
    sampler = make_noise_sampler("simplex")
    gen = torch.Generator().manual_seed(1234)
    test = SyntheticMRIDataset(img_size=tuple(args["img_size"]), seed=1)
    x0 = to_nchw(np.stack([test[i]["image"] for i in range(HELD_OUT)]))
    max_t = min(int(args["sample_distance"]), int(args["T"]))
    t = torch.linspace(0, max_t - 1, HELD_OUT).round().long()
    noise = sampler(x0.shape, t, gen)
    anomalous = SyntheticAnomalyDataset(img_size=tuple(args["img_size"]),
                                        length=VOLUMES)
    images = np.concatenate([anomalous[i]["image"] for i in range(VOLUMES)])
    masks = np.concatenate([anomalous[i]["mask"] for i in range(VOLUMES)])
    shape = (images.shape[0], 1) + images.shape[1:3]
    bank = torch.stack([sampler(shape, torch.full((shape[0],), s), gen)
                        for s in range(LAMBDA)])
    return (x0, t, noise), (images, masks, bank)


def score(root: str, token: str, args, held, chain):
    """The held-out loss, Dice and AUC of `token`'s trained parameters."""
    payload, _ = load_checkpoint(root, token)
    model = unet_from_args(args, 1)
    model.load_state_dict(payload["model"])
    model.eval()
    sched = schedule_from_args(args)
    x0, t, noise = held
    images, masks, bank = chain
    with torch.inference_mode():
        eps = model(dm.sample_q(sched, x0, t, noise), t)
        loss = float(((eps - noise) ** 2).mean())
        recon = dm.forward_backward(model, sched, to_nchw(images), LAMBDA,
                                    None, noise_sampler=lambda s, tt, g: bank[tt[0]])
    batched = M.batched_anomaly_metrics(images, to_nhwc(recon), masks)
    return {"heldout_loss": loss, "dice": float(np.mean(batched["dice"])),
            "auc": float(np.mean(batched["auc"]))}


def run(seeds: int = 5, epochs: int = CONFIG["EPOCHS"], out: str = OUT):
    res = {"config": {**CONFIG, "EPOCHS": epochs},
           "steps": (epochs + 1) * CONFIG["iters_per_epoch"],
           "held_out": HELD_OUT, "lambda": LAMBDA, "volumes": VOLUMES,
           "jax": {}, "port": {}}
    with tempfile.TemporaryDirectory(prefix="f3-spread-") as root:
        for seed in range(seeds):
            for side, trainer in (("jax", train_jax), ("port", train_port)):
                token = f"spread{side}_s{seed}"
                write_config(root, token, seed, epochs)
                seconds = trainer(root, token)
                args = load_args(token, config_dir=os.path.join(root, "configs"))
                if seed == 0 and side == "jax":
                    held, chain = fixed_inputs(args)
                res[side][f"seed{seed}"] = {
                    **score(root, token, args, held, chain),
                    "train_seconds": seconds}
                print(f"{side} seed {seed}: {res[side][f'seed{seed}']}",
                      flush=True)
    res["compare"] = {
        m: compare([res["port"][f"seed{s}"][m] for s in range(seeds)],
                   [res["jax"][f"seed{s}"][m] for s in range(seeds)])
        for m in METRICS}
    for m, c in res["compare"].items():
        print(f"{m}: port {c['port']['mean']:.5f} +- {c['port']['std']:.5f}, "
              f"JAX {c['jax']['mean']:.5f} +- {c['jax']['std']:.5f}; Welch p "
              f"{c['welch_p']:.4f}, F {c['f']:.2f} p {c['f_p']:.4f}", flush=True)
    save_results(ROOT, out, res)
    return res


def main(argv=None):
    p = argparse.ArgumentParser(prog="scripts/torch_f3_cpu_spread.py")
    p.add_argument("--seeds", type=int, default=5)
    p.add_argument("--epochs", type=int, default=CONFIG["EPOCHS"])
    p.add_argument("--out", default=OUT)
    ns = p.parse_args(sys.argv[1:] if argv is None else argv)
    torch.set_num_threads(4)
    return run(ns.seeds, ns.epochs, ns.out)


if __name__ == "__main__":
    main()
