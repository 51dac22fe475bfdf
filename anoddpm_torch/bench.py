"""Headline benchmark of the port on one card: ``python -m anoddpm_torch.bench``.

Counterpart of `bench.py` (the JAX package's): 256^2 slices per second at
lambda = 250 partial diffusion, simplex noise, bf16 UNet (attention at 16
and 8, 2 heads), one q-jump then the reverse chain; and the paper-config
training rate with its MFU.  Prints ONE JSON line with `bench.py`'s keys
(`metric`, `value`, `unit`, `vs_baseline`, `batch_per_chip`,
`n_repeats`, `value_iqr`, and outside quick mode the paper-config keys),
plus the card, the norm path and the peak that the MFU divides by.

Protocol (`bench.py:33-224`): a seeded init, then +0.01 on every
parameter (the inference cells); fresh generator seeds every repeat; one
warm-up run; `torch.cuda.synchronize` around each repeat; the median and
IQR of 5.  Knobs, read as `bench.py` reads them: BENCH_QUICK (batch 4,
lambda 50, the headline alone), BENCH_BATCH, BENCH_DDIM_STEPS (15),
BENCH_DDIM_ETA (1.0), BENCH_BASE_CHANNELS (64), BENCH_S2D (2),
BENCH_RECON_REPEATS (1), BENCH_SIMPLEX_TABLE (0), BENCH_BF16_NORM (1) and
BENCH_PALLAS_NORM (0); and the port's BENCH_NORM_IMPL ("kernel", the
default: K2 at every norm+SiLU site, so that the headline runs K1 and K2;
"flax": the JAX headline's own model, where the two norm knobs act).

The train cell times `training.make_multi_step` at 8 substeps, batch 32:
8 eager train steps per call (a Python loop of launches, no graph).  Its
MFU is the FLOPs of one train step at the same remat policy, counted by
`torch.utils.flop_counter.FlopCounterMode` (convolutions and matmuls,
forward and backward), over the time per step and the H100 SXM5's bf16
dense peak.  Runs on the card unless `device="cpu"` is passed.
"""

from __future__ import annotations

import copy
import json
import os
import subprocess
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

from . import diffusion as dm
from .device import DeviceLike, resolve_device
from .models.unet import UNet
from .ops.noise import make_noise_sampler
from .schedule import get_beta_schedule, make_schedule
from .training import (REMAT_POLICIES, init_train_state, make_multi_step,
                       make_optimizer, make_train_step)

# NVIDIA H100 Tensor Core GPU datasheet, H100 SXM5: 1,979 bf16 TFLOPS with
# sparsity, half of it dense.
PEAK_TFLOPS_BF16 = 989.4
PEAK_SOURCE = ("NVIDIA H100 Tensor Core GPU datasheet, H100 SXM5 bf16 Tensor "
               "Core, dense (1,979 TFLOPS with sparsity)")
# BASELINE.json's target for the headline: a target, not a measurement.
BASELINE_SLICES_PER_S = 50.0
T_TRAIN_MAX = 800           # max_t of the bench's train step (bench.py)


def norm_from_env() -> Dict:
    """The UNet's norm options from BENCH_NORM_IMPL, BENCH_BF16_NORM and
    BENCH_PALLAS_NORM (defaults "kernel", on, off, as bench.py's)."""
    return dict(norm_impl=os.environ.get("BENCH_NORM_IMPL", "kernel"),
                bf16_norm=os.environ.get("BENCH_BF16_NORM", "1") == "1",
                pallas_norm=os.environ.get("BENCH_PALLAS_NORM", "0") == "1")


def card_info(device: torch.device) -> Dict:
    """The card's name and `nvidia-smi`'s name and power limit; the CPU
    says so."""
    if device.type != "cuda":
        return {"device": str(device)}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    return {"device": torch.cuda.get_device_name(device), "nvidia_smi": smi}


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def bench_unet(img: int, base_channels: int, space_to_depth: int = 1,
               norm: Optional[Dict] = None, device: DeviceLike = "cpu",
               perturb: bool = True, seed: int = 0) -> UNet:
    """bench.py's UNet: attention at 16 and 8 with 2 heads, bf16, from a
    seeded init on the CPU, with +0.01 on every parameter when `perturb`
    (so that the zero-initialised layers do not shortcut the math)."""
    torch.manual_seed(seed)
    model = UNet(img_size=img, base_channels=base_channels, in_channels=1,
                 attention_resolutions="16,8", n_heads=2,
                 space_to_depth=space_to_depth, dtype=torch.bfloat16,
                 **(norm or {}))
    if perturb:
        with torch.no_grad():
            for p in model.parameters():
                p.add_(0.01)
    return model.to(device)


def run_bench(batch: int, t_distance: int = 250, img: int = 256,
              base_channels: int = 128, noise_kind: str = "simplex",
              repeats: int = 5, warmup: bool = True, ddim_steps: int = 0,
              ddim_eta: float = 1.0, space_to_depth: int = 1,
              recon_repeats: int = 1, norm: Optional[Dict] = None,
              device: DeviceLike = None) -> Tuple[float, Dict]:
    """Slices per second of one partial-diffusion chain on `batch` slices
    (DDPM, or DDIM-`ddim_steps` at `ddim_eta`), `recon_repeats` chains per
    anomaly map; (median rate, spread) over `repeats` timed runs."""
    device = resolve_device(device)
    model = bench_unet(img, base_channels, space_to_depth, norm, device)
    sched = make_schedule(get_beta_schedule(1000, "linear")).to(device)
    sampler = make_noise_sampler(
        noise_kind, table=os.environ.get("BENCH_SIMPLEX_TABLE", "0") == "1")
    x = torch.zeros((batch, 1, img, img), device=device)

    def fb(seed: int) -> torch.Tensor:
        gen = torch.Generator(device=device).manual_seed(seed)
        with torch.inference_mode():
            if ddim_steps:
                return dm.forward_backward_ddim(model, sched, x, t_distance,
                                                ddim_steps, gen,
                                                noise_sampler=sampler,
                                                eta=ddim_eta)
            return dm.forward_backward(model, sched, x, t_distance, gen,
                                       noise_sampler=sampler)

    if warmup:
        fb(999)
        sync(device)
    times = []
    for i in range(repeats):
        sync(device)
        t0 = time.perf_counter()
        for j in range(recon_repeats):
            fb(i * 131 + j)
        sync(device)
        times.append(time.perf_counter() - t0)
    med = float(np.median(times))
    q1, q3 = (float(np.percentile(times, q)) for q in (25, 75))
    spread = {"n": repeats, "sec_median": med, "sec_iqr": (q1, q3),
              "sps_iqr": (batch / q3, batch / q1), "sec": times}
    return batch / med, spread


def count_flops(fn) -> int:
    """FLOPs of the convolutions and matmuls that fn() runs
    (`FlopCounterMode`), whatever the device."""
    counter = FlopCounterMode(display=False)
    with counter:
        fn()
    return counter.get_total_flops()


def unet_fwd_flops(batch: int, base: int, s2d: int = 1, img: int = 256,
                   norm: Optional[Dict] = None,
                   device: DeviceLike = None) -> int:
    """FLOPs of one forward of bench.py's UNet at `batch` (on the meta
    device a norm path that launches no kernel is needed: "flax")."""
    device = resolve_device(device)
    with torch.device(device):
        model = UNet(img_size=img, base_channels=base, in_channels=1,
                     attention_resolutions="16,8", n_heads=2,
                     space_to_depth=s2d, dtype=torch.bfloat16, **(norm or {}))
        x = torch.zeros((batch, 1, img, img))
        t = torch.zeros((batch,), dtype=torch.int64)
    with torch.inference_mode():
        return count_flops(lambda: model(x, t))


def mfu(flops: float, seconds: float, device: torch.device) -> Optional[float]:
    """The share of the card's bf16 dense peak that `flops` in `seconds`
    reach; None off the card."""
    if device.type != "cuda":
        return None
    return flops / seconds / (PEAK_TFLOPS_BF16 * 1e12)


def train_step_flops(model: UNet, batch: int, img: int,
                     remat: Optional[str] = None) -> int:
    """FLOPs of one train step of bench.py's recipe (simplex noise,
    t < 800, AdamW 1e-4, clip, EMA) on a copy of `model` at `batch` zeros:
    forward and backward at the `remat` policy, the recompute included."""
    device = next(model.parameters()).device
    model = copy.deepcopy(model)
    state = init_train_state(model, make_optimizer(model.parameters(), 1e-4))
    sched = make_schedule(get_beta_schedule(1000, "linear")).to(device)
    step = make_train_step(sched, make_noise_sampler("simplex"),
                           max_t=T_TRAIN_MAX, remat=remat)
    x = torch.zeros((batch, 1, img, img), device=device)
    gen = torch.Generator(device=device).manual_seed(0)
    return count_flops(lambda: step(state, x, gen))


def train_probe(batch: int = 8, img: int = 256, base_channels: int = 128,
                substeps: int = 8, repeats: int = 5, space_to_depth: int = 1,
                remat: Optional[str] = None, norm: Optional[Dict] = None,
                device: DeviceLike = None) -> Dict:
    """The fused multi-step train bench (`run_train_bench`) with its
    readings: ms and images/s per step (eager steps, `substeps` per call),
    the FLOPs of one step, the MFU against PEAK_TFLOPS_BF16 (None off the
    card: the peak is the card's), and the timed calls' seconds."""
    if remat not in REMAT_POLICIES:
        raise ValueError(f"remat must be one of {REMAT_POLICIES}, got {remat!r}")
    device = resolve_device(device)
    model = bench_unet(img, base_channels, space_to_depth, norm, device,
                       perturb=False)
    flops = train_step_flops(model, batch, img, remat)
    sched = make_schedule(get_beta_schedule(1000, "linear")).to(device)
    state = init_train_state(model, make_optimizer(model.parameters(), 1e-4))
    multi = make_multi_step(make_train_step(
        sched, make_noise_sampler("simplex"), max_t=T_TRAIN_MAX, remat=remat),
        substeps)
    x = torch.from_numpy(np.random.default_rng(0).uniform(
        -1, 1, (substeps, batch, 1, img, img)).astype(np.float32)).to(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    m = multi(state, x, torch.Generator(device=device).manual_seed(99))
    sync(device)
    times = []
    for i in range(repeats):
        xs = x + i * 1e-6
        gen = torch.Generator(device=device).manual_seed(i)
        sync(device)
        t0 = time.perf_counter()
        m = multi(state, xs, gen)
        sync(device)
        times.append(time.perf_counter() - t0)
    sec_per_step = float(np.median(times)) / substeps
    loss = float(m["loss"])
    if not np.isfinite(loss):
        raise RuntimeError(f"train bench: loss {loss}")
    peak = (torch.cuda.max_memory_allocated(device) / 2 ** 30
            if device.type == "cuda" else None)
    return {"batch": batch, "substeps": substeps, "remat": remat or "none",
            "ms_per_step": sec_per_step * 1e3,
            "imgs_per_sec": batch / sec_per_step,
            "tflop_per_step": flops / 1e12,
            "mfu": mfu(flops, sec_per_step, device),
            "sec_per_call": times, "loss": loss, "peak_memory_gib": peak}


def run_train_bench(batch: int = 8, img: int = 256, base_channels: int = 128,
                    substeps: int = 8, repeats: int = 5,
                    space_to_depth: int = 1, norm: Optional[Dict] = None,
                    device: DeviceLike = None) -> Tuple[float, float]:
    """(training images/s, MFU) of the fused-substep train step
    (`bench.py:98-155`)."""
    p = train_probe(batch, img, base_channels, substeps, repeats,
                    space_to_depth, norm=norm, device=device)
    return p["imgs_per_sec"], p["mfu"]


def main(device: DeviceLike = None) -> Dict:
    device = resolve_device(device)
    quick = os.environ.get("BENCH_QUICK") == "1"
    batch = int(os.environ.get("BENCH_BATCH", "4" if quick else "32"))
    t_distance = 50 if quick else 250
    ddim_steps = int(os.environ.get("BENCH_DDIM_STEPS", "15"))
    ddim_eta = float(os.environ.get("BENCH_DDIM_ETA", "1.0"))
    base = int(os.environ.get("BENCH_BASE_CHANNELS", "64"))
    s2d = int(os.environ.get("BENCH_S2D", "2"))
    recon_reps = int(os.environ.get("BENCH_RECON_REPEATS", "1"))
    norm = norm_from_env()

    ddim_sps, spread = run_bench(batch, t_distance=t_distance,
                                 base_channels=base, space_to_depth=s2d,
                                 ddim_steps=ddim_steps, ddim_eta=ddim_eta,
                                 recon_repeats=recon_reps, norm=norm,
                                 device=device)
    result = {
        "metric": f"256^2 MRI slices/sec/card (lambda={t_distance} partial "
                  f"diffusion, base-{base} s2d-{s2d} UNet, DDIM-{ddim_steps} "
                  f"eta={ddim_eta} reverse, simplex, bf16, norm_impl "
                  f"{norm['norm_impl']}; the PyTorch port on one card)",
        "value": round(ddim_sps, 3),
        "unit": "slices/sec/card",
        "vs_baseline": round(ddim_sps / BASELINE_SLICES_PER_S, 3),
        "batch_per_chip": batch,
        "n_repeats": spread["n"],
        "value_iqr": [round(v, 3) for v in spread["sps_iqr"]],
    }
    if not quick:
        paper_ddpm, pd_spread = run_bench(8, t_distance=t_distance,
                                          base_channels=128, norm=norm,
                                          device=device)
        paper_ddim, _ = run_bench(8, t_distance=t_distance,
                                  base_channels=128, ddim_steps=ddim_steps,
                                  ddim_eta=ddim_eta, norm=norm, device=device)
        result["paper_config_ddpm_full_chain"] = round(paper_ddpm, 3)
        result["paper_config_ddpm_full_chain_iqr"] = [
            round(v, 3) for v in pd_spread["sps_iqr"]]
        result["paper_config_ddim"] = round(paper_ddim, 3)
        paper_ddpm32, _ = run_bench(32, t_distance=t_distance,
                                    base_channels=128, norm=norm,
                                    device=device)
        result["paper_config_ddpm_full_chain_vb32"] = round(paper_ddpm32, 3)
        train_ips, train_mfu = run_train_bench(batch=32, norm=norm,
                                               device=device)
        result["train_imgs_per_sec_chip_paper_config"] = round(train_ips, 2)
        result["train_mfu_paper_config"] = (None if train_mfu is None
                                            else round(train_mfu, 4))
        result["train_note"] = ("8 eager train steps per make_multi_step "
                                "call, batch 32, no CUDA graph")
    result["norm"] = norm
    result["peak_tflops_bf16"] = PEAK_TFLOPS_BF16
    result["peak_source"] = PEAK_SOURCE
    result.update(card_info(device))
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
