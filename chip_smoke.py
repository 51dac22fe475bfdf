#!/usr/bin/env python3
"""Drive the PyTorch port (anoddpm_torch) on one NVIDIA card and check it.

    python3 chip_smoke.py

run from the root of a checkout, on a machine with a CUDA card, `nvcc` and
PyTorch built for CUDA.  Phases, each of which fails the run when it fails:

1. the card's name, power limit (`nvidia-smi`) and TF32 flags;
2. build every kernel of the detection path from `anoddpm_torch/csrc/`;
3. kernel K1 (simplex octave field) against its plain PyTorch version at the
   main path's shape: 4 fields of 256^2, 6 octaves, per-field t;
4. kernel K2 (GroupNorm(32)+SiLU) against its plain version at every
   (C, H, W) that args256syn128's UNet gives it at batch 4, in fp32 and
   bf16, with `F.silu(F.group_norm(...))` timed as the library yardstick;
5. a small fp32 UNet chain on the card against the same chain on the CPU
   (plain versions), with one injected noise bank;
6. the main path: args256syn128 at full width (256^2, base 128, lambda 200
   DDPM, simplex noise) with seeded random weights, saved as a checkpoint
   and run through `detect.anomalous_metric_calculation` on 2 synthetic
   volumes, with the kernels' launch counts read around that call.

The line before the last is the JSON kernel table; the last line is
{"ok": true, "device": {...}}.  Exits non-zero on any failure, and when
CUDA is unavailable.
"""

import json
import math
import os
import subprocess
import sys
import tempfile
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
FP32_OPS_PER_S = 67e12      # H100 SXM float32 outside the tensor cores
DEVICE = "cuda"
CONFIG = "256syn128"
BATCH = 4                   # slices per volume: the main path's batch
LAMBDA = 200
VOLUMES = 2
K1_TOL = 1e-5               # K1 vs plain, per pixel; >= 99.7% must be within
K2_TOL = 1e-4               # K2 vs plain: atol = rtol (fp32); bf16: 1 ulp
# K1's ALU operations, counted from csrc/simplex3_octave_field.cu: the cell
# walk, region tests, extra-vertex offsets and octave accumulation per
# pixel and octave, and the offset, falloff, lattice hash, gradient and dot
# product per lattice vertex evaluated (4 corners in the two tetrahedron
# regions, 6 in the octahedron, plus 2 extra vertices everywhere).
K1_OPS_PER_PIXEL_OCTAVE = 64
K1_OPS_PER_VERTEX = 70


def log(msg):
    print(msg, flush=True)


def require(ok, msg):
    """Fail the run (assert would vanish under python -O)."""
    if not ok:
        raise RuntimeError(msg)


def cuda_ms(fn, reps):
    """Mean device milliseconds of fn() over reps launches, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_info():
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    log(f"device: {name} (count {torch.cuda.device_count()}); nvidia-smi name, "
        "power limit:")
    log(smi)
    log(f"tf32: matmul {torch.backends.cuda.matmul.allow_tf32}, "
        f"cudnn {torch.backends.cudnn.allow_tf32}; torch {torch.__version__}, "
        f"cuda {torch.version.cuda}")
    return name


def build_kernels():
    from anoddpm_torch.ops import _build
    t0 = time.time()
    _build.build()
    log(f"build: {time.time() - t0:.1f} s for {', '.join(_build.SOURCES)} "
        f"into {_build.BUILD_DIR}")


def k1_operations(t, shape_hw, octaves, frequency):
    """K1's ALU operations for these inputs: the vertices each pixel visits
    depend on the region of its lattice cell, counted here per octave."""
    from anoddpm_torch.ops import simplex as sx
    h, w = shape_hw
    yy = torch.arange(h, dtype=torch.float32, device=t.device).view(1, h, 1)
    xx = torch.arange(w, dtype=torch.float32, device=t.device).view(1, 1, w)
    ops = 0
    for scale, _ in sx.octave_schedule(octaves, 0.8, frequency):
        x, y, z = torch.broadcast_tensors(xx * scale, yy * scale,
                                          t.view(-1, 1, 1) * scale)
        _, _, in_sum = sx._skew(x, y, z)
        middle = ((in_sum > 1.0) & (in_sum < 2.0)).sum().item()
        vertices = 6 * x.numel() + 2 * middle    # 4 or 6 corners, 2 extras
        ops += K1_OPS_PER_PIXEL_OCTAVE * x.numel() + K1_OPS_PER_VERTEX * vertices
    return ops


def check_k1():
    from anoddpm_torch.ops import simplex as sx
    n, hw, octaves, freq = BATCH, (256, 256), 6, 64.0
    gen = torch.Generator(device=DEVICE).manual_seed(11)
    seeds = torch.randint(0, 1 << 32, (n,), generator=gen, device=DEVICE,
                          dtype=torch.int64)
    t = torch.tensor([0.0, 57.0, 123.0, 199.0], device=DEVICE)
    got = sx.batched_fractal3_fixed_t(seeds, t, hw, octaves, 0.8, freq)
    want = sx._fractal3_fixed_t_plain(seeds, t, hw, octaves, 0.8, freq)
    torch.cuda.synchronize()
    diff = (got - want).abs()
    within = (diff <= K1_TOL).float().mean().item()
    max_err = diff.max().item()
    require(torch.isfinite(got).all(), "K1 gave non-finite values")
    require(within >= 0.997, f"K1: only {within:.5f} of pixels within {K1_TOL}")
    ms = cuda_ms(lambda: sx.batched_fractal3_fixed_t(seeds, t, hw, octaves, 0.8, freq), 50)
    plain_ms = cuda_ms(lambda: sx._fractal3_fixed_t_plain(seeds, t, hw, octaves, 0.8, freq), 5)
    ops = k1_operations(t, hw, octaves, freq)
    bound = max(4 * n * hw[0] * hw[1] / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S) * 1e3
    log(f"K1 n={n} {hw[0]}x{hw[1]} oct={octaves}: mismatch fraction "
        f"{1 - within:.3e} (|d|>{K1_TOL}), max|d| {max_err:.3e}, kernel "
        f"{ms:.4f} ms, plain {plain_ms:.3f} ms, bound {bound:.4f} ms "
        f"({ops:.3e} ops), std {got.std().item():.4f}")
    return dict(name="simplex3_octave_field", route="cuda",
                source="anoddpm_torch/csrc/simplex3_octave_field.cu",
                replaces="scripts/pallas_vs_xla_noise.py:41",
                max_abs_err=max_err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by="operations", library_ms=None)


def k2_sites(model):
    """(shape, dtype) of every K2 call in one forward of `model` at batch 4:
    one per NormSiLU module (85 for args256syn128)."""
    from anoddpm_torch.models.unet import NormSiLU
    seen = []
    hooks = [m.register_forward_pre_hook(
        lambda mod, inp: seen.append((tuple(inp[0].shape), inp[0].dtype)))
        for m in model.modules() if isinstance(m, NormSiLU)]
    x = torch.zeros((BATCH, 1, 256, 256), device=DEVICE)
    with torch.inference_mode():
        model(x, torch.zeros((BATCH,), dtype=torch.int64, device=DEVICE))
    for h in hooks:
        h.remove()
    require(len(seen) == len(hooks),
            f"{len(seen)} K2 calls, {len(hooks)} sites")
    log(f"K2 sites per UNet forward: {len(seen)}")
    return seen


def bf16_ulp(v):
    return torch.exp2(torch.floor(torch.log2(v.abs().clamp_min(1e-30))) - 7)


def check_k2(sites):
    import torch.nn.functional as F
    from anoddpm_torch.ops import group_norm_silu as gn
    gen = torch.Generator(device=DEVICE).manual_seed(12)
    timing, max_err = {}, 0.0
    for shape in sorted({s for s, _ in sites}, key=lambda s: (s[1], s[2])):
        c = shape[1]
        x32 = torch.randn(shape, generator=gen, device=DEVICE) * 1.7 + 0.4
        gamma = 1 + 0.1 * torch.randn(c, generator=gen, device=DEVICE)
        beta = 0.1 * torch.randn(c, generator=gen, device=DEVICE)
        for dtype in (torch.float32, torch.bfloat16):
            x = x32.to(dtype)
            got = gn.group_norm_silu(x, gamma, beta).float()
            want = gn._plain(x, gamma, beta, 1e-5)[0].float()
            diff = (got - want).abs()
            if dtype == torch.float32:
                ok = (diff <= K2_TOL + K2_TOL * want.abs()).all().item()
            else:
                ok = (diff <= torch.clamp(bf16_ulp(want), min=K2_TOL)).all().item()
            err = diff.max().item()
            max_err = max(max_err, err)
            require(ok,
                    f"K2 {shape} {dtype}: max|d| {err:.3e} out of tolerance")
            ms = cuda_ms(lambda: gn.group_norm_silu(x, gamma, beta), 20)
            plain_ms = cuda_ms(lambda: gn._plain(x, gamma, beta, 1e-5), 5)
            g_, b_ = gamma.to(dtype), beta.to(dtype)
            lib_ms = cuda_ms(lambda: F.silu(F.group_norm(x, 32, g_, b_)), 20)
            bound = 2 * x.numel() * x.element_size() / HBM_BYTES_PER_S * 1e3
            timing[(shape, dtype)] = (ms, plain_ms, lib_ms, bound)
            log(f"K2 {shape} {str(dtype)[6:]}: max|d| {err:.3e}, kernel "
                f"{ms:.4f} ms, plain {plain_ms:.4f} ms, library {lib_ms:.4f} ms, "
                f"bound {bound:.4f} ms")
    # one UNet forward's worth: the 85 calls at their own shapes and dtypes
    total = [sum(timing[s][i] for s in sites) for i in range(4)]
    log(f"K2 per UNet forward ({len(sites)} calls): kernel {total[0]:.3f} ms, "
        f"plain {total[1]:.3f} ms, library {total[2]:.3f} ms, bound "
        f"{total[3]:.3f} ms")
    return dict(name="group_norm_silu", route="cuda",
                source="anoddpm_torch/csrc/group_norm_silu.cu",
                replaces="anoddpm_tpu/ops/pallas_norm.py:63",
                max_abs_err=max_err, ms=total[0], plain_ms=total[1],
                bound_ms=total[3], bound_by="bytes", library_ms=total[2])


def check_small_chain():
    """A 32^2 fp32 UNet chain (lambda 10) on the card, through both kernels'
    wrappers, against the same chain on the CPU through the plain versions,
    with one noise bank injected on both sides and TF32 off."""
    import numpy as np
    from anoddpm_torch import detect, schedule
    from anoddpm_torch.models.unet import NormSiLU, UNet
    torch.manual_seed(3)
    cpu = UNet(img_size=32, base_channels=32, channel_mults=(1, 2),
               attention_resolutions="16")
    with torch.no_grad():
        for p in cpu.parameters():
            p.add_(0.05 * torch.randn_like(p))
    gpu = UNet(img_size=32, base_channels=32, channel_mults=(1, 2),
               attention_resolutions="16").to(DEVICE)
    gpu.load_state_dict(cpu.state_dict())
    sched = schedule.make_schedule(schedule.get_beta_schedule(20, "cosine"))
    rng = np.random.default_rng(4)
    images = rng.uniform(-1, 1, (2, 32, 32, 1)).astype(np.float32)
    masks = (rng.random((2, 32, 32, 1)) > 0.9).astype(np.float32)
    bank = torch.from_numpy(rng.normal(size=(20, 2, 1, 32, 32)).astype(np.float32))
    banks = {"cpu": bank, DEVICE: bank.to(DEVICE)}
    sampler = lambda s, t, g: banks[t.device.type][t[0]]
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        launches = torch_launches()
        out_g, rec_g = detect.evaluate_anomaly_batch(
            gpu.eval(), sched.to(DEVICE), images, masks,
            torch.Generator(DEVICE), sampler, 10)
        sites = sum(isinstance(m, NormSiLU) for m in gpu.modules())
        require(torch_launches()[1] - launches[1] == 10 * sites,
                "K2 was not launched on the card path")
        out_c, rec_c = detect.evaluate_anomaly_batch(
            cpu.eval(), sched, images, masks, torch.Generator(), sampler, 10)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
    err = float(np.abs(rec_g - rec_c).max())
    log(f"small chain card vs CPU: max|d recon| {err:.3e}, AUC "
        f"{out_g['auc']} vs {out_c['auc']}")
    require(np.isfinite(rec_g).all() and err <= 1e-3,
            f"small chain: max|d recon| {err}")
    require(np.allclose(out_g["auc"], out_c["auc"], atol=1e-3),
            "small chain: AUC differs between card and CPU")


def torch_launches():
    from anoddpm_torch.ops.group_norm_silu import group_norm_silu
    from anoddpm_torch.ops.simplex import batched_fractal3_fixed_t
    return batched_fractal3_fixed_t.launches, group_norm_silu.launches


def reset_launches():
    from anoddpm_torch.ops.group_norm_silu import group_norm_silu
    from anoddpm_torch.ops.simplex import batched_fractal3_fixed_t
    batched_fractal3_fixed_t.launches = 0
    group_norm_silu.launches = 0


def seeded_model(args):
    """args' UNet on the card with every parameter drawn from a seeded
    generator (non-zero, so the zero-init output convs do not make eps 0)."""
    from anoddpm_torch.models.unet import unet_from_args
    model = unet_from_args(args, 1).to(DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(int(args["seed"] or 0))
    with torch.no_grad():
        for name, p in model.named_parameters():
            noise = torch.randn(p.shape, generator=gen, device=DEVICE)
            if p.dim() > 1:
                p.copy_(noise / math.sqrt(p[0].numel()))
            elif ".norm" in name or name.startswith("out_norm"):
                p.copy_((1.0 if name.endswith("weight") else 0.0) + 0.05 * noise)
            else:
                p.copy_(0.02 * noise)
    return model.eval()


def main_path(model, args, k2_per_forward):
    from anoddpm_torch import checkpoint, detect
    from anoddpm_torch.data.datasets import anomalous_dataset_from_args
    from anoddpm_torch.ops.noise import sampler_from_args
    from anoddpm_torch.schedule import schedule_from_args
    with tempfile.TemporaryDirectory() as root:
        checkpoint.save_checkpoint(root, args, 0, {}, model.state_dict(),
                                   final=True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.time()
        summary = detect.anomalous_metric_calculation(
            token=CONFIG, root_dir=root, max_volumes=VOLUMES, device=DEVICE)
        torch.cuda.synchronize()
        wall = time.time() - t0
        k1, k2 = torch_launches()
        with open(os.path.join(root, "metrics", f"args{CONFIG}.csv")) as f:
            csv = f.read().strip()
    log(f"main path: {VOLUMES} volumes x {BATCH} slices, lambda {LAMBDA}: "
        f"{wall:.2f} s including checkpoint load; launches K1 {k1}, K2 {k2}")
    log(f"metrics csv: {csv!r}")
    require(k1 == VOLUMES * (LAMBDA + 1), f"K1 launched {k1} times")
    require(k2 == VOLUMES * k2_per_forward * LAMBDA, f"K2 launched {k2} times")
    require(all(math.isfinite(summary[k]) for k in detect.METRIC_NAMES),
            f"non-finite detection metrics: {summary}")
    # the steady rate: one more volume group on the warm model
    sched = schedule_from_args(args).to(DEVICE)
    sample = anomalous_dataset_from_args(ROOT, args)[0]
    gen = torch.Generator(device=DEVICE).manual_seed(5)
    torch.cuda.synchronize()
    t0 = time.time()
    out, _ = detect.evaluate_anomaly_batch(
        model, sched, sample["image"], sample["mask"], gen,
        sampler_from_args(args), LAMBDA)
    torch.cuda.synchronize()
    group_s = time.time() - t0
    slices = len(out["auc"])
    log(f"steady volume group: {group_s:.3f} s = {slices / group_s:.3f} slices/s, "
        f"{group_s / LAMBDA * 1e3:.3f} ms per reverse step; AUC "
        f"{sum(out['auc']) / slices:.4f}; peak memory of the main path "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return k1, k2


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from anoddpm_torch.config import load_args

    t_start = time.time()
    name = device_info()
    build_kernels()
    k1_row = check_k1()
    args = load_args(CONFIG, config_dir=os.path.join(ROOT, "configs"))
    model = seeded_model(args)
    sites = k2_sites(model)
    k2_row = check_k2(sites)
    check_small_chain()
    k1_row["launches"], k2_row["launches"] = main_path(model, args, len(sites))
    log(f"total {time.time() - t_start:.1f} s")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: row[k] for k in keys}
                                  for row in (k1_row, k2_row)]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
