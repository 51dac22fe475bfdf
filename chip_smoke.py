#!/usr/bin/env python3
"""Drive the PyTorch port (anoddpm_torch) on one NVIDIA card and check it.

    python3 chip_smoke.py

run from the root of a checkout, on a machine with a CUDA card, `nvcc` and
PyTorch built for CUDA.  Phases, each of which fails the run when it fails:

1. the card's name, power limit (`nvidia-smi`) and TF32 flags;
2. build every kernel of the detection path from `anoddpm_torch/csrc/`, and
   find which optional writers this machine has (matplotlib for plots,
   imageio for videos): a missing one is replaced by a stub that writes
   nothing, and the run prints which and why;
3. kernel K1 (simplex octave field) against its plain PyTorch version at the
   main path's shape: 4 fields of 256^2, 6 octaves, per-field t; and its
   registers, spills and resident blocks as built; then at the detection
   suite's shapes: frequency 2^1 .. 2^7 at 1, 4 and 32 fields, each with
   its device-only time and issue bound;
4. kernel K2 (GroupNorm(32)+SiLU), with its mean and rstd, against its
   plain version at every (C, H, W) that args256syn128's UNet gives it at
   batch 4, in fp32 and bf16, with `F.silu(F.group_norm(...))` timed as the
   library yardstick;
   each kernel's time back to back (host gaps included), its device-only
   time (calls captured in a CUDA graph and replayed) and its host
   microseconds per call at a small shape; then at all 85 sites at the
   suite's batches 1, 19 and 32, device-only per UNet forward against the
   bytes bound;
5. kernel K2b (K2's gradient) against its plain version at every (C, H, W)
   of those sites at the training batch of 8, in fp32 and bf16, twice
   (the two runs must agree bit for bit), with each shape's plan and share
   of its bytes bound, and the autograd backward of
   `F.silu(F.group_norm(x.float(), ...))` timed as the library yardstick;
6. a small fp32 UNet chain on the card against the same chain on the CPU
   (plain versions), with one injected noise bank;
7. a small fp32 train step on the card against the same step on the CPU
   (injected t and noise, TF32 off), then `train.train` at that size on
   the card, through the test-set suite;
8. the detection path: args256syn128 at full width (256^2, base 128,
   lambda 200 DDPM, simplex noise) with seeded random weights, saved as a
   checkpoint and run through `detect.anomalous_metric_calculation` on 2
   synthetic volumes, with the kernels' launch counts read around that
   call;
9. the detection suite at full width on the same weights: DDIM-15 at eta 1
   and DDIM-25 at eta 0 through `anomalous_metric_calculation` on one
   volume group (exact launch counts, a steady group timed, two eta = 0
   runs from one seed equal), and `graph_data` over lambda = 5 .. 160 at
   the lambda batch of 32 (exact launch counts, 32 finite CSV rows; a
   chunk at lambda = 160 equal to `forward_backward` from one seed);
10. the training path: `train.train` on args256syn128 at full width (batch
   8, bf16, simplex noise) from seeded weights, with only EPOCHS,
   iters_per_epoch and checkpoint_every cut: 12 steps through the epoch-0
   VLB sweep, the periodic checkpoint and the final one, then a resume
   with RESUME_RECENT for one more epoch; the launch counts are read
   around each call, the restored AdamW state is compared with the saved
   one, and a steady window of train steps is timed; then `roc_data` on
   one volume at lambda 200 from that run's final checkpoint;
11. the suite at 32^2 (T 200): methods A and B, `detection_A_fixedT`,
   `anomalous_validation`, and `train.train` with save_imgs and save_vids
   through 500 epochs and the test-set suite with its videos, each file
   under the name the JAX package gives it; then one detection pass each
   on an MVTec leather fixture (3 channels) and a DAGM carpet fixture,
   PNGs written by the port's encoder;
12. the MRI configuration: configs/args28.json (256^2, base 128, simplex,
   batch 1, bf16) on fixture files written from a seed in NFBS's and
   Edinburgh's layouts, through `python -m anoddpm_torch.data.preprocess`,
   `train.train` (only EPOCHS, iters_per_epoch and checkpoint_every cut;
   exact launches per step), timed windows of train steps with simplex,
   simplex_randParam and random noise under sync-debug "error",
   `anomalous_metric_calculation` on the preprocessed volume (4 slices,
   lambda 200; exact launches, the CSV), a steady volume group, and
   `data.inspect` in compare mode.

13. the data-parallel and training paths: `sharded_anomalous_metrics` at
   full width over an NCCL mesh of one rank (the only size one card
   allows) on one volume, with exact launches; the context-encoder curve
   of `roc_data` beside the training phase's checkpoint; the DDP train step
   (NCCL, world size 1) against the plain one at 32^2 (fp32, TF32 off),
   two gloo ranks on the card (spawned processes) against one, and
   args256syn128 at batch 8 with the plain step, the DDP step and DDP
   copying gradients out of its buckets timed in turns, one step of each
   profiled
   (the ops and kernels where DDP spends more than the plain step);
   each remat policy against none at 32^2, then at full width with its ms
   per step, peak memory and launches; `make_multi_step` on args_dptest
   (2 substeps) under sync-debug "error";
14. the context encoder at 256^2 (a short training, one volume scored, no
   K1/K2 launch), every figure generator at 32^2 under the JAX package's
   file names, and the host C++ noise oracle built by g++ here, holding the
   table-path field computed on the card;
15. the quality campaign: `campaigns.flagship.run` under a directory in
   build/ on an args256syn128 copy at full width, cut to EPOCHS 2 x 4
   steps, 1 anomalous volume, the test-set suite at 4 images, figures off:
   every stage with exact launches (per train step, per DDPM-200 and
   DDIM-15 group, the suite), a rerun that skips every stage (no train
   call, no launch), then 3 epochs, which resume from params-final;
16. the s2d64 campaigns: args256syn64s2d at full width (256^2 through a
   space-to-depth of 2 into a 128^2 UNet of base 64, bf16, batch 8, 2
   channels per GroupNorm group at the top level), K2's device-only ms
   per forward at batch 4 and K2b's per train step at batch 8 against
   their bytes bounds, K1 at the training batch's 8 fields; then under a
   directory in build/, cut to EPOCHS 2 x 8 steps and 1 volume with the
   test-set suite off: seed 1 trained by `seed_replication.
   ensure_trained`, `diffuse_calibration` at 2 severities,
   `train_longer` one epoch further (RESUME_FINAL) and its three
   protocols, `dense_sweep` at every 250th lambda on that model (its
   train gate skips), each call with exact launches; a rerun of all of
   them calls and launches nothing;
17. the measuring entry points: `anoddpm_torch.bench` at quick sizes
   (the headline DDIM-15 on the s2d64 UNet and the paper DDPM chain at
   lambda 50, batch 4; three train steps of the paper config through
   `bench.train_probe`), the UNet's FLOP count on the card against the
   meta device's, `norm_impl="flax"` at args256syn128's and s2d64's
   widths forward and backward (K2 and K2b in their flax order at every
   site without `pallas_norm`; with it in their own order exactly at the
   sites that pass the Pallas gate, the flax order at the rest; the two
   orders counted apart), the flax order of K2 and K2b against the plain
   composition on the CPU at every (C, H, W, dtype) of both models' sites
   with `bf16_path` off and on, its device-only times per forward and per
   train step at both configs beside its plain composition's and its
   bound, ms per forward and per train step of the three norm paths at
   s2d64, and `campaigns.substep_probe` cut to 1 epoch (and epoch 0) of 8
   iterations at 4 and 8 substeps, each with exact launches;
18. the JAX package's random streams (`rng: "jax"`) at args256syn64s2d's
   full width in the flax order: threefry's words (`bits`, `randint`) made
   on the card bit-equal to the host's, and its normals within the
   erfinv bound, for the first 16 steps' t and seeds of seed 0 and for
   one detection group's keys; epoch 0 of seed 0 (the JAX init, 2
   dispatches of 8 steps on the band recipe's batches) under sync-debug
   "error" with exactly 1 K1, 71 flax-order K2 and 142 flax-order K2b a
   step, its loss printed beside the JAX package's TPU log (.15949, not
   held); and ms per train step with the JAX key and with a torch
   Generator, in turns.

From phase 13 on, every (shape, dtype) that K2 and K2b launch at is
recorded, and after each phase K2 and K2b are held against their plain
versions at each shape not held before (the 2 gloo ranks report theirs).

Phase 3 also holds K1's parameters-from-device entry (randParam) against
its plain version at all 23 RAND_PARAM_TABLE triples, the simplex volume
through K1 against the plain volume, and the table and 2-D noise paths
(plain PyTorch) on the card against the CPU, with their times.

The line before the last is the JSON kernel table; the last line is
{"ok": true, "device": {...}}.  Exits non-zero on any failure, and when
CUDA is unavailable.
"""

import contextlib
import copy
import functools
import io
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
# H100 SXM issue rates, per SM and clock (132 SMs at the 1.98 GHz boost clock
# that the data sheet's 67 TFLOP/s fp32 = 132 x 128 x 2 FMA x clock assumes):
# 4 schedulers x 32 lanes issue 128 instructions, the fp32 pipes take 128,
# the int32 pipes 64, conversions and the MUFU unit 16 (CUDA C++ Programming
# Guide, arithmetic instruction throughput, compute capability 9.0); shared
# memory returns 128 bytes a clock, one word to each of 32 lanes.
SM_CLOCKS_PER_S = 132 * 1.98e9
ISSUE_PER_CLOCK = {"all": 128, "int32": 64, "cvt": 16, "lds": 32}
DEVICE = "cuda"
CONFIG = "256syn128"
BATCH = 4                   # slices per volume: the main path's batch
LAMBDA = 200
VOLUMES = 2
K1_TOL = 1e-5               # K1 vs plain, per pixel; >= 99.7% must be within
K2_TOL = 1e-4               # K2 vs plain: atol = rtol (fp32); bf16: 1 ulp
K2_STATS_TOL = 1e-5         # K2's fp32 mean and rstd vs plain, absolute
K2_HOST_SHAPE = (4, 512, 8, 8)  # the main path's most frequent K2 shape
TRAIN_BATCH = 8             # args256syn128's Batch_Size
K2B_TOL = 1e-4              # K2b vs plain: dx atol = rtol (fp32), bf16 1 ulp;
                            # dgamma, dbeta within 1e-4 of their max |value|
K2B_HOST_SHAPE = (8, 512, 8, 8)
SMALL_TRAIN_TOL = 1e-4      # small fp32 train step, card vs CPU
TRAIN_CUTS = {"EPOCHS": 2, "iters_per_epoch": 4, "checkpoint_every": 2,
              "T": 400}     # the VLB sweep's depth; lambda 200 still fits
# The detection suite's shapes: K1 at methods A / A_fixedT's frequencies
# 2^1..2^7 for 1 field (methods, validation), 4 (a volume group), 8 (a
# train batch: the s2d64 noise is drawn at 256^2, before the
# space-to-depth) and 32 (a lambda chunk: q-jump t = lambda - 1); K2 at
# batch 1, 19 and 32.
K1_FREQUENCIES = [float(2 ** i) for i in range(1, 8)]
K1_FIELD_T = {1: [249.0], 4: [0.0, 57.0, 123.0, 199.0],
              8: [float(97 * i + 13) for i in range(8)],
              32: [float(5 * i + 4) for i in range(32)]}
K2_BATCHES = (1, 19, 32)
DDIM_PROTOCOLS = ((15, 1.0), (25, 0.0))     # (steps, eta)
GRAPH_LAMBDAS = list(range(5, 161, 5))      # 32 lambdas, one chunk at 256^2
SMALL_T = 200                               # the 32^2 suite's schedule length
STEADY_STEPS = 10           # timed train steps at full width
# The MRI configuration: configs/args28.json (the paper's simplex model) at
# full width on fixture files in NFBS's and Edinburgh's layouts, with only
# EPOCHS, the iterations per epoch and checkpoint_every cut (and the
# test-set suite skipped, as in the training phase).
MRI_CONFIG = "28"
MRI_CUTS = {"EPOCHS": 0, "iters_per_epoch": 4, "checkpoint_every": 1000,
            "T": 400}       # as TRAIN_CUTS
NFBS_SHAPE = (256, 256, 192)            # NFBS T1 volumes; coronal slices on axis 1
EDINBURGH_SHAPE = (256, 256, 160)       # slices x H x W after preprocess's rot90
EDINBURGH_OTHERS = (210, 64, 48)        # the other 21 volumes, for inspect's draws
NOISE_KINDS = ("simplex", "simplex_randParam", "random")
NOISE_HW = (256, 256)                   # the noise kinds' field size
NOISE_VOLUME_Z = 64                     # planes of the simplex volume
# K1's instructions by class for one pixel: the least the function needs in
# the form the kernel computes it (csrc/simplex3_octave_field.cu), every
# float operation rounded on its own as the plain version does it, every
# integer step one instruction where the card has one that does it (IMAD
# for a multiply-add, LOP3 for a xor of three words, IADD3 for a sum of
# three).  Classes: fp32: each __f*_rn, float compare, select and max;
# int32: integer multiply, add, logic, shift, compare and select; cvt:
# floor and float<->int conversion; lds: a shared-memory load of one word
# per lane.  Counted:
# - per pixel and octave: x and y at the octave's scale (z, the scale and
#   the amplitude are the same for a whole field and not counted), the
#   skew, cell, in-cell and squish terms, the distances to the far faces
#   of the cell (dx - 1, ...), the region tests, the division by 103 as a
#   product by its rounded reciprocal and two corrections, the
#   accumulation; and the hash products of both faces on each axis,
#   (xsb + o) * HX ... for o = 0, 1, with the seed folded into z;
# - per region: the extra-vertex logic of a tetrahedron or of the
#   octahedron;
# - per vertex: falloff, lattice hash (xor of its words, 3 mix rounds,
#   mod 24 and the table address), the gradient as 3 loads from a table,
#   dot product; per cube corner 3 squish subtracts unless it is (0,0,0);
#   per extra vertex its runtime offsets (their sum, 3 hash products, 4
#   conversions, the squish and 6 subtracts);
# - the sum of the region's vertices, one add fewer than it has.
# Corners visited: region 1 (in_sum <= 1) the 4 with offset sum 0 or 1,
# region 2 (>= 2) the 4 with sum 2 or 3, the octahedron the 6 with sum 1
# or 2.
K1_PER_PIXEL_OCTAVE = {"fp32": 32, "int32": 8, "cvt": 6}
K1_PER_REGION = {"tetra": {"fp32": 10, "int32": 17},
                 "octa": {"fp32": 19, "int32": 22}}
K1_PER_CORNER = {"fp32": 15, "int32": 13, "lds": 3}
K1_PER_EXTRA_VERTEX = {"fp32": 22, "int32": 18, "cvt": 4, "lds": 3}
K1_CORNERS = {"r1": (4, 3), "r2": (4, 4), "octa": (6, 6)}  # (all, not (0,0,0))


def log(msg):
    print(msg, flush=True)


def require(ok, msg):
    """Fail the run (assert would vanish under python -O)."""
    if not ok:
        raise RuntimeError(msg)


def cuda_ms(fn, reps):
    """Mean milliseconds of fn() over reps calls back to back, after a
    warm-up: device time, plus the host's gaps where it cannot keep up."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps=20, replays=3):
    """Device-only milliseconds per fn(): `reps` calls captured in one CUDA
    graph, replayed `replays` times and timed with CUDA events, so that the
    host's per-call cost is out of the way."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * replays)


def host_us(fn, calls=1000):
    """Host microseconds per fn() call, at a shape where the device keeps up
    with the host (so the launch queue never fills)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    per_call = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return per_call


def profiled_device_ms(fn, reps=10):
    """Device milliseconds per fn() from `torch.profiler`: the sum of the
    CUDA kernels' own time over `reps` calls (for calls that a CUDA graph
    cannot capture, such as an autograd backward)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = sum(e.self_device_time_total for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA)
    require(total > 0, "the profiler saw no device time")
    return total / 1e3 / reps


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


def k1_instructions(t, shape_hw, octaves, frequency):
    """K1's instructions by class for these inputs: which corners a pixel
    visits depends on the region of its lattice cell, counted per octave."""
    from anoddpm_torch.ops import simplex as sx
    h, w = shape_hw
    yy = torch.arange(h, dtype=torch.float32, device=t.device).view(1, h, 1)
    xx = torch.arange(w, dtype=torch.float32, device=t.device).view(1, 1, w)
    count = {"fp32": 0, "int32": 0, "cvt": 0, "lds": 0}
    for scale, _ in sx.octave_schedule(octaves, 0.8, frequency):
        x, y, z = torch.broadcast_tensors(xx * scale, yy * scale,
                                          t.view(-1, 1, 1) * scale)
        _, _, in_sum = sx._skew(x, y, z)
        pixels = {"r1": (in_sum <= 1.0).sum().item(),
                  "r2": (in_sum >= 2.0).sum().item()}
        pixels["octa"] = x.numel() - pixels["r1"] - pixels["r2"]
        for region, n in pixels.items():
            corners, shifted = K1_CORNERS[region]
            per = K1_PER_REGION["octa" if region == "octa" else "tetra"]
            for k in count:
                count[k] += n * (K1_PER_PIXEL_OCTAVE.get(k, 0) + per.get(k, 0)
                                 + corners * K1_PER_CORNER.get(k, 0)
                                 + 2 * K1_PER_EXTRA_VERTEX.get(k, 0))
            count["fp32"] += n * (3 * shifted + corners + 1)
    return count


def issue_bound_ms(count):
    """Least milliseconds to issue these instructions: the larger of all of
    them at the schedulers' rate and each narrow class at its own pipe's."""
    need = {"all": sum(count.values()),
            **{k: count[k] for k in ISSUE_PER_CLOCK if k != "all"}}
    return max(need[k] / (ISSUE_PER_CLOCK[k] * SM_CLOCKS_PER_S)
               for k in need) * 1e3


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
    field = lambda: sx.batched_fractal3_fixed_t(seeds, t, hw, octaves, 0.8, freq)
    ms = cuda_ms(field, 50)
    device_ms = graph_ms(field)
    plain_ms = cuda_ms(lambda: sx._fractal3_fixed_t_plain(seeds, t, hw, octaves, 0.8, freq), 5)
    small = lambda: sx.batched_fractal3_fixed_t(seeds, t, (16, 16), octaves, 0.8, freq)
    host = host_us(small)
    count = k1_instructions(t, hw, octaves, freq)
    bound = max(4 * n * hw[0] * hw[1] / HBM_BYTES_PER_S * 1e3,
                issue_bound_ms(count))
    attr = sx.attributes(torch.cuda.current_device())
    log(f"K1 built: {attr.registers} registers and {attr.local_bytes} local "
        f"(spill) bytes per thread, {attr.shared_bytes} shared bytes and "
        f"{attr.threads} threads per block, {attr.blocks_per_sm} blocks "
        f"resident per SM, {attr.resident} on the card")
    log(f"K1 n={n} {hw[0]}x{hw[1]} oct={octaves}: mismatch fraction "
        f"{1 - within:.3e} (|d|>{K1_TOL}), max|d| {max_err:.3e}, kernel "
        f"{ms:.4f} ms back to back, {device_ms:.4f} ms device-only, plain "
        f"{plain_ms:.3f} ms, bound {bound:.4f} ms (instructions: "
        f"{count['fp32']:.4e} fp32, {count['int32']:.4e} int32, "
        f"{count['cvt']:.4e} cvt, {count['lds']:.4e} lds); host {host:.2f} us per call at n={n} "
        f"16x16; std {got.std().item():.4f}")
    return dict(name="simplex3_octave_field", route="cuda",
                source="anoddpm_torch/csrc/simplex3_octave_field.cu",
                replaces="scripts/pallas_vs_xla_noise.py:41",
                max_abs_err=max_err, ms=ms, device_ms=device_ms,
                host_us_per_call=host, plain_ms=plain_ms, bound_ms=bound,
                bound_by="operations", library_ms=None)


def k2_sites(model, batch=BATCH, img=256):
    """(shape, dtype) of every K2 call in one forward of `model` at `batch`
    on img^2 input: one per NormSiLU module (85 for args256syn128 and
    args28)."""
    from anoddpm_torch.models.unet import NormSiLU
    seen = []
    hooks = [m.register_forward_pre_hook(
        lambda mod, inp: seen.append((tuple(inp[0].shape), inp[0].dtype)))
        for m in model.modules() if isinstance(m, NormSiLU)]
    x = torch.zeros((batch, 1, img, img), device=DEVICE)
    with torch.inference_mode():
        model(x, torch.zeros((batch,), dtype=torch.int64, device=DEVICE))
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
            got, mean, rstd = gn.group_norm_silu_with_stats(x, gamma, beta)
            want, wmean, wrstd = gn._plain(x, gamma, beta, 1e-5)
            got, want = got.float(), want.float()
            diff = (got - want).abs()
            stats_err = max((mean - wmean).abs().max().item(),
                            (rstd - wrstd).abs().max().item())
            require(stats_err <= K2_STATS_TOL,
                    f"K2 {shape} {dtype}: mean/rstd off by {stats_err:.3e}")
            if dtype == torch.float32:
                ok = (diff <= K2_TOL + K2_TOL * want.abs()).all().item()
            else:
                ok = (diff <= torch.clamp(bf16_ulp(want), min=K2_TOL)).all().item()
            err = diff.max().item()
            max_err = max(max_err, err)
            require(ok,
                    f"K2 {shape} {dtype}: max|d| {err:.3e} out of tolerance")
            kernel = lambda: gn.group_norm_silu(x, gamma, beta)
            g_, b_ = gamma.to(dtype), beta.to(dtype)
            library = lambda: F.silu(F.group_norm(x, 32, g_, b_))
            ms, lib_ms = cuda_ms(kernel, 20), cuda_ms(library, 20)
            dev_ms, lib_dev_ms = graph_ms(kernel), graph_ms(library)
            plain_ms = cuda_ms(lambda: gn._plain(x, gamma, beta, 1e-5), 5)
            bound = 2 * x.numel() * x.element_size() / HBM_BYTES_PER_S * 1e3
            timing[(shape, dtype)] = (ms, dev_ms, plain_ms, lib_ms, lib_dev_ms,
                                      bound)
            plan = gn.plan(shape[0], c, shape[2] * shape[3], dtype)
            log(f"K2 {shape} {str(dtype)[6:]} {plan}: max|d| {err:.3e}, "
                f"mean/rstd {stats_err:.3e}; kernel {ms:.4f} ms back to back, "
                f"{dev_ms:.4f} ms device-only; plain {plain_ms:.4f} ms; "
                f"library {lib_ms:.4f} ms back to back, {lib_dev_ms:.4f} ms "
                f"device-only; bound {bound:.4f} ms")
    # one UNet forward's worth: the 85 calls at their own shapes and dtypes
    total = [sum(timing[s][i] for s in sites) for i in range(6)]
    host, lib_host = k2_host_us()
    log(f"K2 per UNet forward ({len(sites)} calls): kernel {total[0]:.3f} ms "
        f"back to back, {total[1]:.3f} ms device-only; plain {total[2]:.3f} ms; "
        f"library {total[3]:.3f} ms back to back, {total[4]:.3f} ms "
        f"device-only; bound {total[5]:.3f} ms; host {host:.2f} us per call "
        f"(library {lib_host:.2f} us) at {K2_HOST_SHAPE} bf16")
    return dict(name="group_norm_silu", route="cuda",
                source="anoddpm_torch/csrc/group_norm_silu.cu",
                replaces="anoddpm_tpu/ops/pallas_norm.py:63",
                max_abs_err=max_err, ms=total[0], device_ms=total[1],
                host_us_per_call=host, plain_ms=total[2], bound_ms=total[5],
                bound_by="bytes", library_ms=total[3],
                library_device_ms=total[4])


def k2_host_us():
    """Host microseconds per K2 call, and per library call, at a small
    shape of the main path."""
    import torch.nn.functional as F
    from anoddpm_torch.ops import group_norm_silu as gn
    x = torch.randn(K2_HOST_SHAPE, device=DEVICE).to(torch.bfloat16)
    gamma = torch.ones(K2_HOST_SHAPE[1], device=DEVICE)
    beta = torch.zeros(K2_HOST_SHAPE[1], device=DEVICE)
    g_, b_ = gamma.to(x.dtype), beta.to(x.dtype)
    return (host_us(lambda: gn.group_norm_silu(x, gamma, beta)),
            host_us(lambda: F.silu(F.group_norm(x, 32, g_, b_))))


def check_k2b(sites):
    """K2b against `_plain_backward` at every (C, H, W) of the K2 sites at
    the training batch, fp32 and bf16; per train step (85 sites at their
    own dtype) its time back to back and device-only, the plain version's,
    the library backward's, and the bytes bound."""
    import torch.nn.functional as F
    from anoddpm_torch.ops import group_norm_silu as gn
    # host time before this phase runs torch.profiler, and again after its
    # sessions (where it reads higher; both are printed)
    host = k2b_host_us()
    gen = torch.Generator(device=DEVICE).manual_seed(13)
    timing, max_err = {}, 0.0
    for chw in sorted({s[1:] for s, _ in sites}, key=lambda s: (s[1], s[0])):
        shape, c = (TRAIN_BATCH,) + chw, chw[0]
        x32 = torch.randn(shape, generator=gen, device=DEVICE) * 1.7 + 0.4
        g32 = torch.randn(shape, generator=gen, device=DEVICE)
        gamma = 1 + 0.1 * torch.randn(c, generator=gen, device=DEVICE)
        beta = 0.1 * torch.randn(c, generator=gen, device=DEVICE)
        for dtype in (torch.float32, torch.bfloat16):
            x, go = x32.to(dtype), g32.to(dtype)
            _, mean, rstd = gn.group_norm_silu_with_stats(x, gamma, beta)
            err, rel = k2b_case(x, go, gamma, beta, mean, rstd)
            max_err = max(max_err, err)
            kernel = lambda: gn.group_norm_silu_backward(x, go, gamma, beta,
                                                         mean, rstd)
            xl = x.detach().clone().requires_grad_()
            gl = gamma.clone().requires_grad_()
            bl = beta.clone().requires_grad_()
            yl = F.silu(F.group_norm(xl.float(), 32, gl, bl))
            gof = go.float()
            library = lambda: torch.autograd.grad(yl, (xl, gl, bl), gof,
                                                  retain_graph=True)
            ms, dev_ms = cuda_ms(kernel, 20), graph_ms(kernel)
            lib_ms, lib_dev_ms = cuda_ms(library, 10), profiled_device_ms(library)
            plain_ms = cuda_ms(lambda: gn._plain_backward(x, go, gamma, beta,
                                                          mean, rstd), 3)
            nbytes = (3 * x.numel() * x.element_size() + 4 * c * 4
                      + 2 * TRAIN_BATCH * 32 * 4)
            bound = nbytes / HBM_BYTES_PER_S * 1e3
            timing[(shape, dtype)] = (ms, dev_ms, plain_ms, lib_ms, lib_dev_ms,
                                      bound)
            log(f"K2b {shape} {str(dtype)[6:]} "
                f"{gn.backward_plan(shape[0], c, chw[1] * chw[2], dtype)}: dx "
                f"max|d| {err:.3e}, dgamma/dbeta {rel:.2e} of max, bit-identical "
                f"rerun; kernel {ms:.4f} ms back to back, {dev_ms:.4f} ms "
                f"device-only; plain {plain_ms:.4f} ms; library {lib_ms:.4f} ms "
                f"back to back, {lib_dev_ms:.4f} ms device-only; bound {bound:.4f} ms "
                f"({bound / dev_ms:.1%} of it device-only)")
    host_after = k2b_host_us()
    steps = [((TRAIN_BATCH,) + s[1:], dt) for s, dt in sites]
    total = [sum(timing[k][i] for k in steps) for i in range(6)]
    log(f"K2b per train step ({len(sites)} calls, {gn.BACKWARD_LAUNCHES} "
        f"launches each): kernel {total[0]:.3f} ms back to back, {total[1]:.3f} "
        f"ms device-only; plain {total[2]:.3f} ms; library {total[3]:.3f} ms "
        f"back to back, {total[4]:.3f} ms device-only; bound {total[5]:.3f} ms "
        f"({total[5] / total[1]:.1%} of it device-only); host {host:.2f} us per "
        f"call at {K2B_HOST_SHAPE} bf16 before the profiler's sessions, "
        f"{host_after:.2f} us after them")
    return dict(name="group_norm_silu_backward", route="cuda",
                source="anoddpm_torch/csrc/group_norm_silu_backward.cu",
                replaces="anoddpm_tpu/ops/pallas_norm.py:141",
                note="K2's gradient: the JAX package computes it in plain XLA "
                     "(_bwd), it has no Pallas form",
                max_abs_err=max_err, ms=total[0], device_ms=total[1],
                host_us_per_call=host, host_us_after_profiler=host_after,
                plain_ms=total[2], bound_ms=total[5],
                bound_by="bytes", library_ms=total[3],
                library_device_ms=total[4])


def k2b_case(x, go, gamma, beta, mean, rstd):
    """K2b on one set of inputs against `_plain_backward`: two runs
    bit-identical, dx within K2B_TOL (fp32) or a bf16 ulp, dgamma and dbeta
    within K2B_TOL of their largest value.  Returns dx's max|d| and
    dgamma/dbeta's error as a share of their largest value."""
    from anoddpm_torch.ops import group_norm_silu as gn
    what = f"K2b {tuple(x.shape)} {x.dtype}"
    got = gn.group_norm_silu_backward(x, go, gamma, beta, mean, rstd)
    again = gn.group_norm_silu_backward(x, go, gamma, beta, mean, rstd)
    want = gn._plain_backward(x, go, gamma, beta, mean, rstd)
    torch.cuda.synchronize()
    require(all(torch.equal(a, b) for a, b in zip(got, again)),
            f"{what}: two runs differ")
    dx, wdx = got[0].float(), want[0].float()
    diff = (dx - wdx).abs()
    if x.dtype == torch.float32:
        ok = (diff <= K2B_TOL + K2B_TOL * wdx.abs()).all().item()
    else:
        ok = (diff <= torch.clamp(bf16_ulp(wdx), min=K2B_TOL)).all().item()
    err = diff.max().item()
    require(ok, f"{what}: dx max|d| {err:.3e} out of tolerance")
    rel = max(((g - w).abs().max() / w.abs().max().clamp_min(1e-30)).item()
              for g, w in zip(got[1:], want[1:]))
    require(rel <= K2B_TOL, f"{what}: dgamma/dbeta off by {rel:.3e} of their "
            "largest value")
    return err, rel


def check_k2b_batch(sites, n):
    """K2b against `_plain_backward` at every K2 site's (C, H, W), each at
    its own dtype, at batch `n`, under `k2b_case`'s rules.  Returns the
    worst dx max|d|."""
    from anoddpm_torch.ops import group_norm_silu as gn
    gen = torch.Generator(device=DEVICE).manual_seed(16)
    worst, worst_rel = 0.0, 0.0
    cases = sorted({(s[1:], dt) for s, dt in sites},
                   key=lambda s: (s[0][1], s[0][0], str(s[1])))
    for chw, dtype in cases:
        shape, c = (n,) + chw, chw[0]
        x = (torch.randn(shape, generator=gen, device=DEVICE) * 1.7 + 0.4).to(dtype)
        go = torch.randn(shape, generator=gen, device=DEVICE).to(dtype)
        gamma = 1 + 0.1 * torch.randn(c, generator=gen, device=DEVICE)
        beta = 0.1 * torch.randn(c, generator=gen, device=DEVICE)
        _, mean, rstd = gn.group_norm_silu_with_stats(x, gamma, beta)
        err, rel = k2b_case(x, go, gamma, beta, mean, rstd)
        worst, worst_rel = max(worst, err), max(worst_rel, rel)
    log(f"K2b at N={n}: all {len(cases)} (C, H, W, dtype) of the {len(sites)} "
        f"sites in tolerance, bit-identical reruns (worst dx max|d| "
        f"{worst:.3e}, dgamma/dbeta {worst_rel:.2e} of max)")
    return worst


def k2b_host_us(gn=None):
    """Host microseconds per K2b call at a small shape of the train step,
    through `gn`, a checkout's `ops.group_norm_silu` (this one's when
    None)."""
    if gn is None:
        from anoddpm_torch.ops import group_norm_silu as gn
    x = torch.randn(K2B_HOST_SHAPE, device=DEVICE).to(torch.bfloat16)
    gamma = torch.ones(K2B_HOST_SHAPE[1], device=DEVICE)
    beta = torch.zeros(K2B_HOST_SHAPE[1], device=DEVICE)
    _, mean, rstd = gn.group_norm_silu_with_stats(x, gamma, beta)
    return host_us(lambda: gn.group_norm_silu_backward(x, x, gamma, beta,
                                                       mean, rstd))


def check_small_chain():
    """A 32^2 fp32 UNet chain (lambda 10) on the card, through both kernels'
    wrappers, against the same chain on the CPU through the plain versions,
    with one noise bank injected on both sides and TF32 off."""
    import numpy as np
    from anoddpm_torch import detect, schedule
    from anoddpm_torch.models.unet import NormSiLU
    cpu = small_unet()
    gpu = small_unet().to(DEVICE)
    sched = schedule.make_schedule(schedule.get_beta_schedule(20, "cosine"))
    rng = np.random.default_rng(4)
    images = rng.uniform(-1, 1, (2, 32, 32, 1)).astype(np.float32)
    masks = (rng.random((2, 32, 32, 1)) > 0.9).astype(np.float32)
    bank = torch.from_numpy(rng.normal(size=(20, 2, 1, 32, 32)).astype(np.float32))
    banks = {"cpu": bank, DEVICE: bank.to(DEVICE)}
    sampler = lambda s, t, g: banks[t.device.type][t[0]]
    with tf32_off():
        launches = torch_launches()
        out_g, rec_g = detect.evaluate_anomaly_batch(
            gpu.eval(), sched.to(DEVICE), images, masks,
            torch.Generator(DEVICE), sampler, 10)
        sites = sum(isinstance(m, NormSiLU) for m in gpu.modules())
        require(torch_launches()[1] - launches[1] == 10 * sites,
                "K2 was not launched on the card path")
        out_c, rec_c = detect.evaluate_anomaly_batch(
            cpu.eval(), sched, images, masks, torch.Generator(), sampler, 10)
    err = float(np.abs(rec_g - rec_c).max())
    log(f"small chain card vs CPU: max|d recon| {err:.3e}, AUC "
        f"{out_g['auc']} vs {out_c['auc']}")
    require(np.isfinite(rec_g).all() and err <= 1e-3,
            f"small chain: max|d recon| {err}")
    require(np.allclose(out_g["auc"], out_c["auc"], atol=1e-3),
            "small chain: AUC differs between card and CPU")


def torch_launches():
    """(K1, K2, K2b, K2 in the flax order, K2b in the flax order) launch
    counts; a path that runs K2 and K2b in their own order launches (k1,
    k2, k2b, 0, 0) (`own_order`)."""
    from anoddpm_torch.ops.group_norm_silu import (group_norm_silu,
                                                   group_norm_silu_backward)
    from anoddpm_torch.ops.simplex import batched_fractal3_fixed_t
    return (batched_fractal3_fixed_t.launches, group_norm_silu.launches,
            group_norm_silu_backward.launches, group_norm_silu.flax_launches,
            group_norm_silu_backward.flax_launches)


def own_order(k1, k2, k2b):
    """The launches of a path with K1, K2 and K2b in their own order and
    nothing in the flax order, as `torch_launches` counts them."""
    return (k1, k2, k2b, 0, 0)


def reset_launches():
    from anoddpm_torch.ops.group_norm_silu import (group_norm_silu,
                                                   group_norm_silu_backward)
    from anoddpm_torch.ops.simplex import batched_fractal3_fixed_t
    batched_fractal3_fixed_t.launches = 0
    group_norm_silu.launches = 0
    group_norm_silu_backward.launches = 0
    group_norm_silu.flax_launches = 0
    group_norm_silu_backward.flax_launches = 0


def small_unet():
    """The 32^2 fp32 UNet of the small phases, with perturbed weights."""
    from anoddpm_torch.models.unet import UNet
    torch.manual_seed(3)
    model = UNet(img_size=32, base_channels=32, channel_mults=(1, 2),
                 attention_resolutions="16")
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.05 * torch.randn_like(p))
    return model


@contextlib.contextmanager
def tf32_off():
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


def check_small_train():
    """One fp32 train step of the 32^2 UNet on the card (K2 with statistics,
    K2b, fused AdamW) against the same step on the CPU (plain versions),
    with t and one noise bank injected and TF32 off; then `train.train` at
    that size on the card, through the test-set suite."""
    import numpy as np
    from anoddpm_torch import schedule, train, training
    from anoddpm_torch.data.synthetic import SyntheticMRIDataset
    from anoddpm_torch.models.unet import NormSiLU
    from anoddpm_torch.ops.group_norm_silu import BACKWARD_LAUNCHES
    cpu = small_unet()
    gpu = small_unet().to(DEVICE)
    sched = schedule.make_schedule(schedule.get_beta_schedule(20, "cosine"))
    rng = np.random.default_rng(6)
    bank = torch.from_numpy(rng.normal(size=(20, 2, 1, 32, 32)).astype(np.float32))
    banks = {"cpu": bank, DEVICE: bank.to(DEVICE)}
    sampler = lambda shape, t, g: banks[t.device.type][t[0]]
    ds = SyntheticMRIDataset(img_size=(32, 32))
    batch = torch.from_numpy(np.stack([ds[0]["image"], ds[1]["image"]])
                             .transpose(0, 3, 1, 2).copy())
    t = torch.tensor([3, 11])
    sites = sum(isinstance(m, NormSiLU) for m in gpu.modules())
    out = {}
    with tf32_off():
        for model in (cpu, gpu):
            dev = next(model.parameters()).device
            state = training.init_train_state(
                model, training.make_optimizer(model.parameters(), 1e-4))
            step = training.make_train_step(sched.to(dev), sampler, max_t=12)
            before = [p.detach().clone() for p in model.parameters()]
            counts = torch_launches()
            m = step(state, batch.to(dev), torch.Generator(dev), t=t.to(dev))
            if dev.type == "cuda":
                got = tuple(a - b for a, b in zip(torch_launches(), counts))
                require(got == own_order(0, sites, sites * BACKWARD_LAUNCHES),
                        f"small train step launched {got}")
            out[dev.type] = (float(m["loss"]), float(m["grad_norm"]),
                             [(p.detach() - b).cpu() for p, b in
                              zip(model.parameters(), before)],
                             [p.grad.cpu() for p in model.parameters()],
                             [b.cpu() for b in before])
    (lc, nc, uc, gc, bc), (lg, ng, ug, gg, _) = out["cpu"], out[DEVICE]
    gmax = max(g.abs().max().item() for g in gc)
    worst = 0.0
    for upd_c, upd_g, g, b in zip(uc, ug, gc, bc):
        keep = g.abs() > 1e-3 * gmax
        floor = torch.from_numpy(np.spacing(b.abs().numpy()))
        excess = ((upd_g - upd_c).abs() - SMALL_TRAIN_TOL * upd_c.abs() - floor)[keep]
        if excess.numel():
            worst = max(worst, excess.max().item())
    # against the largest gradient: at C = 32 a group is one channel, and the
    # biases in front of a norm have a gradient of 0 up to rounding
    grad_err = max((a - b).abs().max().item() for a, b in zip(gg, gc)) / gmax
    log(f"small train step card vs CPU: loss {lg:.7f} vs {lc:.7f}, grad norm "
        f"{ng:.6f} vs {nc:.6f}, clipped grads within {grad_err:.2e} of the "
        f"largest, "
        f"update excess over rtol {SMALL_TRAIN_TOL} + 1 ulp: {worst:.3e}")
    require(abs(lg - lc) <= SMALL_TRAIN_TOL * abs(lc), "small train: loss differs")
    require(abs(ng - nc) <= SMALL_TRAIN_TOL * abs(nc), "small train: grad norm differs")
    require(worst <= 0.0, "small train: update differs")
    args = small_train_args()
    with tempfile.TemporaryDirectory() as root:
        state = train.train(args, root_dir=root, device=DEVICE)
        with open(os.path.join(root, "metrics", "argssmalltrain-test.json")) as f:
            results = json.load(f)
    require(state.step == 2 * args["iters_per_epoch"], f"{state.step} steps")
    require(all(math.isfinite(v) for v in results.values()),
            f"small train: testing gave {results}")


def small_train_args():
    from anoddpm_torch.config import defaultdict_from_json
    return defaultdict_from_json({
        "arg_num": "smalltrain", "img_size": [32, 32], "Batch_Size": 2,
        "EPOCHS": 1, "T": 20, "base_channels": 32, "channel_mults": [1, 2],
        "attention_resolutions": "16", "beta_schedule": "cosine",
        "loss-type": "l2", "lr": 1e-4, "sample_distance": 12,
        "train_start": True, "noise_fn": "simplex", "dataset": "synthetic",
        "iters_per_epoch": 2, "checkpoint_every": 1, "seed": 0,
        "compute_dtype": "bfloat16"})


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
        checkpoint.save_checkpoint(root, args, 0, model.state_dict(),
                                   model.state_dict(), {}, final=True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.time()
        summary = detect.anomalous_metric_calculation(
            token=CONFIG, root_dir=root, max_volumes=VOLUMES, device=DEVICE)
        torch.cuda.synchronize()
        wall = time.time() - t0
        k1, k2, k2b, *flax = torch_launches()
        with open(os.path.join(root, "metrics", f"args{CONFIG}.csv")) as f:
            csv = f.read().strip()
    log(f"detection path: {VOLUMES} volumes x {BATCH} slices, lambda {LAMBDA}: "
        f"{wall:.2f} s including checkpoint load; launches K1 {k1}, K2 {k2}, "
        f"K2b {k2b}")
    log(f"metrics csv: {csv!r}")
    require(k1 == VOLUMES * (LAMBDA + 1), f"K1 launched {k1} times")
    require(k2 == VOLUMES * k2_per_forward * LAMBDA, f"K2 launched {k2} times")
    require(k2b == 0, f"K2b launched {k2b} times without autograd")
    require(flax == [0, 0], f"the flax order launched {flax} times")
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
    return own_order(k1, k2, k2b)


def probe_writers():
    """Which optional writers this machine has: matplotlib (the graph and
    ROC plots), pandas (nothing of the port needs it), imageio and an mp4
    plugin for it (videos; without one they are GIFs).  A writer whose
    package is missing is replaced by a stub that writes nothing, and the
    run says so: the device work does not need them."""
    import importlib.util
    have = {m: importlib.util.find_spec(m) is not None
            for m in ("matplotlib", "pandas", "imageio", "imageio_ffmpeg", "av")}
    log(f"packages: {have}")
    left_out = []
    if not have["imageio"]:
        from anoddpm_torch import visualize
        visualize.save_video = lambda path, frames, row_size=-1, fps=20: path
        left_out.append("videos (visualize.save_video): imageio is not installed")
    if not have["matplotlib"]:
        from anoddpm_torch import detect, graphs
        detect._per_volume_lambda_plot = lambda *a, **k: None
        detect._roc_plot = lambda *a, **k: None
        graphs.graph_dice_comparison = lambda *a, **k: None
        left_out.append("plots (graph's per-volume and comparison plots, the "
                        "ROC figure): matplotlib is not installed")
    for what in left_out:
        log(f"left out: {what}")
    return {"videos": have["imageio"], "plots": have["matplotlib"],
            "mp4": have["imageio"] and (have["imageio_ffmpeg"] or have["av"])}


def check_k1_shapes():
    """K1 against its plain version at the suite's shapes: frequency 2^1 ..
    2^7 (6 octaves, persistence 0.8) at n = 1, 4, 8 and 32 fields of 256^2,
    the standing tolerance; device-only ms and the issue bound of each."""
    from anoddpm_torch.ops import simplex as sx
    hw = (256, 256)
    gen = torch.Generator(device=DEVICE).manual_seed(14)
    worst, table = 0.0, {}
    for freq in K1_FREQUENCIES:
        for n, times in K1_FIELD_T.items():
            seeds = torch.randint(0, 1 << 32, (n,), generator=gen, device=DEVICE,
                                  dtype=torch.int64)
            t = torch.tensor(times, device=DEVICE)
            field = lambda: sx.batched_fractal3_fixed_t(seeds, t, hw, 6, 0.8, freq)
            got = field()
            want = sx._fractal3_fixed_t_plain(seeds, t, hw, 6, 0.8, freq)
            diff = (got - want).abs()
            within = (diff <= K1_TOL).float().mean().item()
            worst = max(worst, diff.max().item())
            require(torch.isfinite(got).all(), f"K1 f={freq} n={n}: non-finite")
            require(within >= 0.997, f"K1 f={freq} n={n}: only {within:.5f} of "
                    f"pixels within {K1_TOL}")
            dev = graph_ms(field, reps=10)
            count = k1_instructions(t, hw, 6, freq)
            bound = max(4 * n * hw[0] * hw[1] / HBM_BYTES_PER_S * 1e3,
                        issue_bound_ms(count))
            table[(freq, n)] = (dev, bound)
            log(f"K1 frequency {freq:g} n={n} 256x256: mismatch fraction "
                f"{1 - within:.3e} (|d|>{K1_TOL}), max|d| {diff.max().item():.3e}; "
                f"{dev:.4f} ms device-only, bound {bound:.4f} ms "
                f"({bound / dev:.1%} of it)")
    return worst, table


def k2_inputs(shape, dtype, gen, backward=False):
    """Seeded K2 inputs at (shape, dtype): x, gamma, beta; with `backward`
    also K2b's output gradient and K2's mean and rstd of x."""
    from anoddpm_torch.ops import group_norm_silu as gn
    c = shape[1]
    x = (torch.randn(shape, generator=gen, device=DEVICE) * 1.7 + 0.4).to(dtype)
    gamma = 1 + 0.1 * torch.randn(c, generator=gen, device=DEVICE)
    beta = 0.1 * torch.randn(c, generator=gen, device=DEVICE)
    if not backward:
        return x, gamma, beta
    go = torch.randn(shape, generator=gen, device=DEVICE).to(dtype)
    _, mean, rstd = gn.group_norm_silu_with_stats(x, gamma, beta)
    return x, gamma, beta, go, mean, rstd


def k2_case(x, gamma, beta):
    """K2 on one set of inputs against `_plain`: the output within K2_TOL
    (fp32) or a bf16 ulp, mean and rstd within K2_STATS_TOL.  Returns the
    output's max|d|."""
    from anoddpm_torch.ops import group_norm_silu as gn
    got, mean, rstd = gn.group_norm_silu_with_stats(x, gamma, beta)
    want, wmean, wrstd = gn._plain(x, gamma, beta, 1e-5)
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    stats_err = max((mean - wmean).abs().max().item(),
                    (rstd - wrstd).abs().max().item())
    if x.dtype == torch.float32:
        ok = (diff <= K2_TOL + K2_TOL * want.abs()).all().item()
    else:
        ok = (diff <= torch.clamp(bf16_ulp(want), min=K2_TOL)).all().item()
    err = diff.max().item()
    require(ok and stats_err <= K2_STATS_TOL,
            f"K2 {tuple(x.shape)} {x.dtype}: max|d| {err:.3e}, mean/rstd "
            f"{stats_err:.3e}")
    return err


def check_k2_batches(sites):
    """K2 against its plain version at every K2 site of one UNet forward
    (each at its own dtype, bf16 at all but the output norm) at the batches
    the suite launches: 1 (methods A/B, validation), 19 and 32 (graph's
    lambda batch); device-only ms per forward against the bytes bound."""
    from anoddpm_torch.ops import group_norm_silu as gn
    gen = torch.Generator(device=DEVICE).manual_seed(15)
    worst, table = 0.0, {}
    for n in K2_BATCHES:
        timing = {}
        for shape, dtype in sorted(set(sites), key=lambda s: (s[0][1], s[0][2], str(s[1]))):
            x, gamma, beta = k2_inputs((n,) + shape[1:], dtype, gen)
            worst = max(worst, k2_case(x, gamma, beta))
            dev = graph_ms(lambda: gn.group_norm_silu(x, gamma, beta), reps=10)
            bound = 2 * x.numel() * x.element_size() / HBM_BYTES_PER_S * 1e3
            timing[(shape, dtype)] = (dev, bound)
            del x
        dev = sum(timing[s][0] for s in sites)
        bound = sum(timing[s][1] for s in sites)
        table[n] = (dev, bound)
        log(f"K2 at N={n}, all {len(sites)} sites in tolerance (worst max|d| "
            f"{worst:.3e}): {dev:.3f} ms device-only per UNet forward, bound "
            f"{bound:.3f} ms ({bound / dev:.1%} of it)")
    return worst, table


def ddim_path(model, args, k2_per_forward):
    """`anomalous_metric_calculation` with sampler=ddim on one volume group
    (4 slices, lambda 200): DDIM-15 at eta 1 (the flagship_ddim15_eta1
    protocol) and DDIM-25 at eta 0, exact launch counts, then a steady group
    timed, and two eta = 0 runs from one seed against each other."""
    from anoddpm_torch import detect, diffusion
    from anoddpm_torch.config import defaultdict_from_json
    from anoddpm_torch.data.datasets import anomalous_dataset_from_args
    from anoddpm_torch.ops.noise import sampler_from_args
    from anoddpm_torch.schedule import schedule_from_args
    sched = schedule_from_args(args).to(DEVICE)
    sampler = sampler_from_args(args)
    sample = anomalous_dataset_from_args(ROOT, args)[0]
    total = [0] * 5
    for steps, eta in DDIM_PROTOCOLS:
        dargs = defaultdict_from_json({**args, "sampler": "ddim",
                                       "ddim_steps": steps, "ddim_eta": eta})
        with tempfile.TemporaryDirectory() as root:
            reset_launches()
            summary = detect.anomalous_metric_calculation(
                dargs, root_dir=root, em=model, sched=sched, max_volumes=1,
                device=DEVICE)
            torch.cuda.synchronize()
            counts = torch_launches()
        want = own_order(1 + (steps if eta > 0 else 0), k2_per_forward * steps, 0)
        log(f"DDIM-{steps} eta={eta:g}: launches K1 {counts[0]}, K2 {counts[1]}, "
            f"K2b {counts[2]} (expected {want}); AUC {summary['auc']:.4f}")
        require(tuple(counts) == want, f"DDIM-{steps}: launches {counts} != {want}")
        require(all(math.isfinite(summary[k]) for k in detect.METRIC_NAMES),
                f"DDIM-{steps}: non-finite metrics {summary}")
        total = [a + b for a, b in zip(total, counts)]

        def fb(x, g):
            return diffusion.forward_backward_ddim(model, sched, x, LAMBDA, steps,
                                                   g, noise_sampler=sampler,
                                                   eta=eta)
        recons = []
        for _ in range(2 if eta == 0 else 1):
            gen = torch.Generator(device=DEVICE).manual_seed(21)
            torch.cuda.synchronize()
            t0 = time.time()
            out, recon = detect.evaluate_anomaly_batch(
                model, sched, sample["image"], sample["mask"], gen, sampler,
                LAMBDA, fb=fb)
            torch.cuda.synchronize()
            wall = time.time() - t0
            recons.append(recon)
            log(f"DDIM-{steps} eta={eta:g} steady volume group: {wall:.3f} s = "
                f"{len(out['auc']) / wall:.3f} slices/s, {wall / steps * 1e3:.3f} "
                f"ms per DDIM step")
        if eta == 0:
            import numpy as np
            d = float(np.abs(recons[0] - recons[1]).max())
            log(f"DDIM-{steps} eta=0, two runs from one seed: max|d| {d:.3e}")
            require(d <= 1e-5, f"DDIM eta=0 reruns differ by {d}")
    return total


def graph_path(model, args, k2_per_forward):
    """`graph_data` over lambda = 5, 10, .., 160 on one volume at the lambda
    batch of 256^2 (one chunk of 32); then a chunk at lambda = 160 against
    `forward_backward(t_distance=160)` from the same generator seed."""
    import numpy as np
    from anoddpm_torch import detect, diffusion
    from anoddpm_torch.data.datasets import anomalous_dataset_from_args
    from anoddpm_torch.ops.noise import sampler_from_args
    from anoddpm_torch.schedule import schedule_from_args
    sched = schedule_from_args(args).to(DEVICE)
    batch = detect._auto_lambda_batch(256)
    max_t = max(GRAPH_LAMBDAS)
    with tempfile.TemporaryDirectory() as root:
        reset_launches()
        t0 = time.time()
        rows = detect.graph_data((args, model, sched), root_dir=root,
                                 lambdas=GRAPH_LAMBDAS, max_volumes=1,
                                 lambda_batch=batch)
        torch.cuda.synchronize()
        wall = time.time() - t0
        counts = torch_launches()
        vol_csv = os.path.join(root, "metrics", f"ARGS={CONFIG}",
                               "synthetic-anomalous-00000.csv")
        with open(vol_csv) as f:
            lines = f.read().splitlines()
    want = own_order(1 + max_t, k2_per_forward * max_t, 0)
    log(f"graph: {len(GRAPH_LAMBDAS)} lambdas at batch {batch}, {wall:.2f} s for "
        f"the call; launches K1 {counts[0]}, K2 {counts[1]}, K2b {counts[2]} "
        f"(expected {want}); peak dice {max(r['dice'] for r in rows):.4f}")
    require(tuple(counts) == want, f"graph: launches {counts} != {want}")
    require(len(lines) == 1 + len(GRAPH_LAMBDAS), f"graph: {len(lines)} CSV lines")
    require(all(math.isfinite(v) for r in rows for v in r.values()),
            "graph: non-finite curve values")
    sample = anomalous_dataset_from_args(ROOT, args)[0]
    x = torch.from_numpy(np.ascontiguousarray(
        sample["image"][1:2].transpose(0, 3, 1, 2))).to(DEVICE).repeat(batch, 1, 1, 1)
    sampler = sampler_from_args(args)
    lam = torch.full((batch,), max_t, dtype=torch.int64, device=DEVICE)
    with torch.inference_mode():
        torch.cuda.synchronize()
        t0 = time.time()
        chunk = diffusion.forward_backward_batched_lambda(
            model, sched, x, lam, max_t,
            torch.Generator(device=DEVICE).manual_seed(31), noise_sampler=sampler)
        torch.cuda.synchronize()
        chunk_s = time.time() - t0
        plain = diffusion.forward_backward(
            model, sched, x, max_t, torch.Generator(device=DEVICE).manual_seed(31),
            noise_sampler=sampler)
    d = (chunk - plain).abs().max().item()
    log(f"graph chunk at batch {batch}, {max_t} masked steps: {chunk_s:.3f} s per "
        f"chunk, {chunk_s / max_t * 1e3:.3f} ms per masked step; every lambda = "
        f"{max_t} vs forward_backward from one seed: bit-identical "
        f"{torch.equal(chunk, plain)}, max|d| {d:.3e}")
    require(torch.equal(chunk, plain), "batched lambda at max_t differs from "
            f"forward_backward by {d}")
    return list(counts)


def roc_path(root, k2_per_forward):
    """`roc_data` for args256syn128 on one volume at lambda 200, reading the
    final checkpoint that the training phase wrote under `root`."""
    import shutil
    from anoddpm_torch import detect
    os.makedirs(os.path.join(root, "configs"), exist_ok=True)
    shutil.copy(os.path.join(ROOT, "configs", f"args{CONFIG}.json"),
                os.path.join(root, "configs"))
    reset_launches()
    t0 = time.time()
    curves = detect.roc_data([CONFIG], root_dir=root, t_distance=LAMBDA,
                             max_volumes=1, ce_token=CONFIG,
                             ce_train_steps=CE_STEPS, device=DEVICE)
    torch.cuda.synchronize()
    counts = torch_launches()
    with open(os.path.join(root, "metrics", "roc-comparison.csv")) as f:
        header = f.readline().strip()
    want = own_order(1 + LAMBDA, k2_per_forward * LAMBDA, 0)
    log(f"roc with the context-encoder curve ({CE_STEPS} CE steps): "
        f"{time.time() - t0:.2f} s, header {header!r}; launches K1 "
        f"{counts[0]}, K2 {counts[1]}, K2b {counts[2]} (expected {want}: the "
        f"context encoder launches none)")
    require(tuple(counts) == want, f"roc: launches {counts} != {want}")
    require(header == f"args{CONFIG}_fpr,args{CONFIG}_tpr,"
            "context-encoder_fpr,context-encoder_tpr", f"roc header {header}")
    for label, (fpr, tpr) in curves.items():
        require(fpr[-1] == 1.0 and tpr[-1] == 1.0,
                f"roc: the {label} curve does not end at (1, 1)")
    return list(counts)


def small_suite_args():
    from anoddpm_torch.config import defaultdict_from_json
    return defaultdict_from_json({
        **small_train_args(), "arg_num": "smallsuite", "T": SMALL_T,
        "sample_distance": 150, "EPOCHS": 500, "iters_per_epoch": 1,
        "checkpoint_every": 1000, "Batch_Size": 8, "save_imgs": True,
        "save_vids": True, "anomalous_volumes": 1})


def files_under(root):
    """Relative paths of the files under root, .mp4 and .gif as .video."""
    out = set()
    for d, _, names in os.walk(root):
        for f in names:
            rel = os.path.relpath(os.path.join(d, f), root)
            out.add(rel[:-4] + ".video" if rel.endswith((".gif", ".mp4")) else rel)
    return out


def small_suite(writers):
    """The 32^2 config on the card (T = 200): methods A and B,
    detection_A_fixedT, anomalous_validation, `train.train` with save_imgs
    and save_vids through 500 epochs of one step and the test-set suite
    with its videos; the files against the names the JAX package writes."""
    from anoddpm_torch import detect, train
    from anoddpm_torch.data.datasets import anomalous_dataset_from_args
    from anoddpm_torch.schedule import schedule_from_args
    args = small_suite_args()
    model = small_unet().to(DEVICE).eval()
    sched = schedule_from_args(args).to(DEVICE)
    sample = anomalous_dataset_from_args(ROOT, args)[0]
    x, mask, fid = sample["image"][1:2], sample["mask"][1:2], sample["filenames"]
    video = "video" if writers["videos"] else None
    with tempfile.TemporaryDirectory() as root:
        reset_launches()
        t0 = time.time()
        detect.detection_A(args, model, sched, x, mask, fid, root_dir=root)
        dice = detect.detection_B(args, model, sched, x, mask, fid, "octave",
                                  root_dir=root, total_avg=2)
        rows = detect.detection_A_fixedT(args, model, sched, x, mask,
                                         t_distance=50)
        val = detect.anomalous_validation((args, model, sched), root_dir=root,
                                          max_slices=2, detection_avg=2)
        sweeps_s = time.time() - t0
        state = train.train(args, root_dir=root, device=DEVICE)
        torch.cuda.synchronize()
        counts = torch_launches()
        got = files_under(root)
    require(rows.shape == (36, 32, 32, 1) and math.isfinite(float(rows.sum())),
            f"detection_A_fixedT gave {rows.shape}")
    require(len(dice) == 2 and len(val) == 2, f"dice {dice}, validation {val}")
    require(state.step == 501, f"small train took {state.step} steps")
    anomalous = f"diffusion-videos/ARGS=smallsuite/Anomalous"
    want = {f"{anomalous}/{fid}/A/freq={i}-t={t}.png"
            for i in range(1, 8) for t in (50, 100)}
    want |= {f"{anomalous}/{fid}/octave/heatmap-t={t}.png" for t in (50, 100)}
    want |= {f"diffusion-training-images/ARGS=smallsuite/EPOCH={e}.png"
             for e in range(0, 501, 50)}
    if video:
        want |= {"diffusion-videos/ARGS=smallsuite/sample-EPOCH=500.video",
                 "diffusion-videos/ARGS=smallsuite/test-set/t=100.video"}
    missing = sorted(want - got)
    require(not missing, f"small suite: missing {missing}")
    # validation's timestep is drawn: per slice one heatmap and one video
    # named t={t}, and method B's heatmaps under {volume}-{slice}/octave
    for s in (0, 1):
        heat = [p for p in got if p.startswith(f"{anomalous}/{fid}/{s}/t=")]
        require(len(heat) == (2 if video else 1), f"validation slice {s}: {heat}")
        require(any(p.startswith(f"{anomalous}/{fid}-{s}/octave/heatmap-t=")
                    for p in got), f"validation slice {s}: no method B heatmap")
    videos_as = ("left out (no imageio)" if not video
                 else "as mp4" if writers["mp4"] else "as GIF")
    log(f"small suite (32^2, T {SMALL_T}): sweeps {sweeps_s:.1f} s, then train "
        f"501 steps with snapshots, videos and the test-set suite; {len(got)} "
        f"files, the JAX package's names ({len(want)} fixed, validation's per "
        f"slice); videos {videos_as}; launches K1 "
        f"{counts[0]}, K2 {counts[1]}, K2b {counts[2]}")
    require(counts[0] > 0 and counts[1] > 0 and counts[2] > 0
            and not any(counts[3:]), f"small suite: launches {counts}")
    return list(counts)


def write_nifti(path, data, code, dtype):
    """A gzipped single-file NIfTI-1 image of `data` stored as `dtype`
    (NIfTI datatype `code`), little-endian, unscaled."""
    import gzip
    import struct
    import numpy as np
    data = np.asarray(data)
    hdr = bytearray(352)
    struct.pack_into("<i", hdr, 0, 348)
    struct.pack_into("<8h", hdr, 40, *((data.ndim,) + data.shape + (1,) * (7 - data.ndim)))
    struct.pack_into("<hh", hdr, 70, code, np.dtype(dtype).itemsize * 8)
    struct.pack_into("<fff", hdr, 108, 352.0, 1.0, 0.0)
    hdr[344:348] = b"n+1\x00"
    with gzip.open(path, "wb", compresslevel=1) as f:
        f.write(bytes(hdr))
        f.write(data.astype("<" + np.dtype(dtype).str[1:]).tobytes(order="F"))


def edinburgh_volume(rng, shape, slices):
    """A post-rot90 Edinburgh volume (S, H, W) of smooth phantom slices (16,
    each held for S / 16 slices) with an ellipsoid lesion over the tumour
    slice range, and its mask."""
    import numpy as np
    from anoddpm_torch.data.synthetic import _phantom
    n, h, w = shape
    lo, hi = slices
    vol = np.repeat(np.stack([_phantom(rng, (h, w)) for _ in range(16)]),
                    -(-n // 16), axis=0)[:n]
    zz, yy, xx = np.ogrid[0:n, 0:h, 0:w]
    centre = ((lo + hi) / 2, 0.55 * h, 0.5 * w)
    radii = ((hi - lo) / 2 + 2, 0.14 * h, 0.16 * w)
    d2 = sum(((g - c) / r) ** 2 for g, c, r in zip((zz, yy, xx), centre, radii))
    mask = d2 < 1.0
    vol = np.where(mask & (vol > 0.05), vol + 0.5 * np.exp(-2.0 * d2), vol)
    return vol.astype(np.float32), mask


def mri_fixtures(datasets):
    """DATASETS/ as `preprocess` and `dataset_from_args` read it, from a
    fixed seed: NFBS Train (2 volumes) and Test (1) at 256 x 256 x 192, int16;
    the 22 Edinburgh raw volumes and masks (17904 at 256 slices of 256 x 160,
    the others at 210 slices of 64 x 48: inspect's compare sheets draw from
    all 22, as the JAX package's do), float32 and uint8.  Returns the seconds
    taken by the NFBS volumes and 17904, and by the 21 others."""
    import numpy as np
    from anoddpm_torch.data.datasets import EDINBURGH_SLICES
    from anoddpm_torch.data.synthetic import _phantom
    t0, others = time.time(), 0.0
    rng = np.random.default_rng(28)
    for sub, names in (("Train", ("A00028", "A00029")), ("Test", ("A00030",))):
        for name in names:
            d = os.path.join(datasets, sub, name)
            os.makedirs(d)
            # 16 phantoms, each held for 16 coronal slices
            vol = np.repeat(np.stack([_phantom(rng, (NFBS_SHAPE[0], NFBS_SHAPE[2]))
                                      for _ in range(16)], axis=1),
                            -(-NFBS_SHAPE[1] // 16), axis=1)[:, :NFBS_SHAPE[1]]
            write_nifti(os.path.join(d, f"sub-{name}_ses-NFB3_T1w.nii.gz"),
                        np.rint(vol * 1000), 4, np.int16)
    ano = os.path.join(datasets, "CancerousDataset", "EdinburghDataset",
                       "Anomalous-T1")
    for sub in ("raw", "mask_raw"):
        os.makedirs(os.path.join(ano, sub))
    for name, slices in sorted(EDINBURGH_SLICES.items()):
        t1 = time.time()
        shape = EDINBURGH_SHAPE if name == "17904" else EDINBURGH_OTHERS
        vol, mask = edinburgh_volume(rng, shape, slices)
        # stored so that preprocess's np.rot90 gives back (S, H, W)
        write_nifti(os.path.join(ano, "raw", f"{name}.nii.gz"),
                    np.rot90(vol * 500, -1), 16, np.float32)
        write_nifti(os.path.join(ano, "mask_raw", f"{name}.nii.gz"),
                    np.rot90(mask, -1), 2, np.uint8)
        if name != "17904":
            others += time.time() - t1
    return time.time() - t0 - others, others


@contextlib.contextmanager
def sync_debug_error():
    """torch.cuda.set_sync_debug_mode("error") for the block: any operation
    that synchronises the host with the card raises."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode("default")


def noise_window(state, batch, sched, targs, kind):
    """STEADY_STEPS train steps with noise `kind` after 3 warm-up steps, the
    whole window under sync-debug "error": a host sync anywhere in the step
    fails the run.  Returns (ms per step, the window's (K1, K2, K2b)
    launches)."""
    from anoddpm_torch import training
    from anoddpm_torch.ops.noise import sampler_from_args
    sampler = sampler_from_args({**targs, "noise_fn": kind})
    max_t = min(int(targs["sample_distance"]), int(targs["T"]))
    gen = torch.Generator(device=DEVICE).manual_seed(31)
    step = training.make_train_step(sched, sampler, max_t=max_t)
    for _ in range(3):
        step(state, batch, gen)
    torch.cuda.synchronize()
    before = torch_launches()
    t0 = time.time()
    with sync_debug_error():
        for _ in range(STEADY_STEPS):
            metrics = step(state, batch, gen)
    torch.cuda.synchronize()
    ms = (time.time() - t0) / STEADY_STEPS * 1e3
    got = [a - b for a, b in zip(torch_launches(), before)]
    require(math.isfinite(float(metrics["loss"])), f"{kind}: loss {metrics['loss']}")
    return ms, got


def mri_path(card):
    """The paper's MRI configuration (args28) at full width on fixture files:
    preprocess's CLI, `train.train` with exact launches per step and its
    final checkpoint, timed windows of train steps with simplex, randParam
    and random noise under sync-debug "error", K2b against its plain version
    at the config's batch of 1 at every K2 site, `anomalous_metric_calculation`
    on the preprocessed volume with exact launches, a steady volume group,
    and `inspect` in compare mode.  Returns the launches by part, the ms per
    step of each noise window, slices/s, and K2b's worst dx max|d|."""
    import numpy as np
    from anoddpm_torch import detect, train
    from anoddpm_torch.config import defaultdict_from_json, load_args
    from anoddpm_torch.data import inspect as dinspect
    from anoddpm_torch.data.datasets import (anomalous_dataset_from_args,
                                             dataset_from_args)
    from anoddpm_torch.data.pipeline import to_nchw
    from anoddpm_torch.models.unet import NormSiLU
    from anoddpm_torch.ops.group_norm_silu import BACKWARD_LAUNCHES
    from anoddpm_torch.ops.noise import sampler_from_args
    from anoddpm_torch.schedule import schedule_from_args
    args = load_args(MRI_CONFIG, config_dir=os.path.join(ROOT, "configs"))
    targs = defaultdict_from_json({**args, **MRI_CUTS, "skip_test_eval": True})
    counts, parts = {}, {}
    with tempfile.TemporaryDirectory() as root:
        datasets = os.path.join(root, "DATASETS")
        parts["fixtures"], parts["fixtures, 21 other Edinburgh"] = mri_fixtures(datasets)
        t0 = time.time()
        proc = subprocess.run(
            [sys.executable, "-m", "anoddpm_torch.data.preprocess", datasets],
            cwd=ROOT, capture_output=True, text=True, timeout=600)
        parts["preprocess"] = time.time() - t0
        require(proc.returncode == 0, f"preprocess failed: {proc.stderr[-2000:]}")
        require("cached: 2 train, 1 test, 22 anomalous volumes" in proc.stdout,
                f"preprocess said {proc.stdout[-300:]!r}")
        log(f"MRI fixtures ({card}): NFBS 2 train + 1 test at {NFBS_SHAPE}, "
            f"Edinburgh 17904 at {EDINBURGH_SHAPE} (S, H, W) and 21 more at "
            f"{EDINBURGH_OTHERS}; preprocess by `python -m "
            f"anoddpm_torch.data.preprocess`")

        iters = MRI_CUTS["iters_per_epoch"]
        steps = (MRI_CUTS["EPOCHS"] + 1) * iters
        sweep_t = int(targs["T"])
        reset_launches()
        t0 = time.time()
        tee = Tee(sys.stdout)
        with contextlib.redirect_stdout(tee):
            state = train.train(targs, root_dir=root, device=DEVICE)
        torch.cuda.synchronize()
        wall = parts["train.train"] = time.time() - t0
        sweep = re.search(r"VLB sweep ([0-9.]+) s", tee.kept.getvalue())
        require(sweep is not None, "MRI train: no VLB sweep was printed")
        parts["train.train, VLB sweep"] = float(sweep.group(1))
        sites = sum(isinstance(m, NormSiLU) for m in state.model.modules())
        got = torch_launches()
        want = own_order(steps, sites * (steps + sweep_t),
                         sites * BACKWARD_LAUNCHES * steps)
        log(f"MRI train.train args{MRI_CONFIG} (batch {targs['Batch_Size']}, "
            f"{targs['compute_dtype']}, {targs['noise_fn']} noise, cut {MRI_CUTS}, "
            f"skip_test_eval): {steps} steps and the {sweep_t}-forward VLB "
            f"sweep in {wall:.1f} s; launches K1 {got[0]}, K2 {got[1]}, K2b "
            f"{got[2]} (expected {want}: per step 1, {sites}, {sites} x "
            f"{BACKWARD_LAUNCHES})")
        require(tuple(got) == want, f"MRI train: launches {got} != {want}")
        require(state.step == steps, f"MRI train took {state.step} steps")
        counts["mri_train"] = list(got)
        final = [d for d, _, _ in os.walk(os.path.join(root, "model"))
                 if d.endswith("params-final")]
        require(len(final) == 1, f"MRI train: final checkpoints {final}")
        # the config's batch is 1: K2b's grid and its dgamma/dbeta sums differ
        # from the batch-8 check's
        t0 = time.time()
        mri_sites = k2_sites(state.model, batch=int(targs["Batch_Size"]))
        require(len(mri_sites) == sites, f"MRI: {len(mri_sites)} K2 calls, {sites} sites")
        k2b_worst = check_k2b_batch(mri_sites, int(targs["Batch_Size"]))
        parts["K2b at N=1"] = time.time() - t0

        sched = schedule_from_args(targs).to(DEVICE)
        ds = dataset_from_args(root, targs)
        batch = to_nchw(np.stack([ds[0]["image"]])).to(DEVICE)
        windows = {}
        counts["mri_noise_windows"] = [0] * 5
        want = own_order(STEADY_STEPS, sites * STEADY_STEPS,
                         sites * BACKWARD_LAUNCHES * STEADY_STEPS)
        for kind in NOISE_KINDS:
            t0 = time.time()
            ms, got = noise_window(state, batch, sched, targs, kind)
            parts[f"{kind} window"] = time.time() - t0
            windows[kind] = ms
            log(f"MRI train step at args{MRI_CONFIG}, batch 1, {kind} noise "
                f"({card}): {ms:.3f} ms per step over {STEADY_STEPS} steps, "
                f"launches K1 {got[0]}, K2 {got[1]}, K2b {got[2]}; sync-debug "
                f"\"error\" over the whole steps")
            require(tuple(got) == want, f"{kind}: launches {got} in "
                    f"{STEADY_STEPS} steps, expected {want}")
            counts["mri_noise_windows"] = [
                a + b for a, b in zip(counts["mri_noise_windows"], got)]
        del state
        torch.cuda.empty_cache()

        reset_launches()
        t0 = time.time()
        summary = detect.anomalous_metric_calculation(
            token=MRI_CONFIG, root_dir=root, max_volumes=1, device=DEVICE)
        torch.cuda.synchronize()
        wall = parts["detection"] = time.time() - t0
        got = torch_launches()
        with open(os.path.join(root, "metrics", f"args{MRI_CONFIG}.csv")) as f:
            csv = f.read().strip()
        log(f"MRI detection: volume 17904, 4 slices, lambda {LAMBDA} DDPM: "
            f"{wall:.2f} s including checkpoint load; launches K1 {got[0]}, "
            f"K2 {got[1]}, K2b {got[2]}; csv {csv!r}")
        require(tuple(got) == own_order(LAMBDA + 1, sites * LAMBDA, 0),
                f"MRI detection: launches {got}")
        require(all(math.isfinite(summary[k]) for k in detect.METRIC_NAMES),
                f"MRI detection metrics {summary}")
        counts["mri_detect"] = list(got)
        _, em, esched = detect._load_eval_model(root, MRI_CONFIG, device=DEVICE)
        sample = anomalous_dataset_from_args(root, targs)[0]
        require(sample["image"].shape == (4, *targs["img_size"], 1) and sample["mask"].sum() > 0,
                f"MRI sample {sample['image'].shape}, mask {sample['mask'].sum()}")
        gen = torch.Generator(device=DEVICE).manual_seed(5)
        torch.cuda.synchronize()
        t0 = time.time()
        out, _ = detect.evaluate_anomaly_batch(em, esched, sample["image"],
                                               sample["mask"], gen,
                                               sampler_from_args(targs), LAMBDA)
        torch.cuda.synchronize()
        group_s = parts["steady group"] = time.time() - t0
        log(f"MRI steady volume group ({card}): {group_s:.3f} s = "
            f"{4 / group_s:.3f} slices/s, {group_s / LAMBDA * 1e3:.3f} ms per "
            f"reverse step; AUC {sum(out['auc']) / 4:.4f}")
        del em
        torch.cuda.empty_cache()

        t0 = time.time()
        dinspect.inspect(targs, root_dir=root, mode="compare")
        sheets = sorted(os.listdir(os.path.join(root, "inspection-outputs",
                                                f"ARGS={MRI_CONFIG}")))
        require(sheets == [f"sheet-{i}.png" for i in range(5)], f"inspect wrote {sheets}")
        parts["inspect"] = time.time() - t0
        log(f"inspect compare: {len(sheets)} sheets")
    log("MRI phase by part (s): " + ", ".join(f"{k} {v:.2f}" for k, v in parts.items()))
    return counts, windows, 4 / group_s, k2b_worst


def check_noise_kinds():
    """K1's parameters-from-device entry against its plain version at all 23
    RAND_PARAM_TABLE triples (n = 4, 256^2, K1's standing rule); the volume
    through K1 against the plain volume; the table and 2-D paths on the card
    against the same calls on the CPU, with their ms per field batch."""
    from anoddpm_torch.ops import simplex as sx
    from anoddpm_torch.ops.noise import RAND_PARAM_TABLE
    hw = NOISE_HW
    gen = torch.Generator(device=DEVICE).manual_seed(23)
    seeds = torch.randint(0, 1 << 32, (BATCH,), generator=gen, device=DEVICE,
                          dtype=torch.int64)
    t = torch.tensor([0.0, 57.0, 123.0, 199.0], device=DEVICE)
    worst = 0.0
    for octaves, pers, freq in RAND_PARAM_TABLE:
        params = torch.tensor([octaves, pers, freq], device=DEVICE)
        got = sx.batched_fractal3_fixed_t_params(seeds, t, hw, params)
        want = sx._fractal3_fixed_t_params_plain(seeds, t, hw, params)
        diff = (got - want).abs()
        within = (diff <= K1_TOL).float().mean().item()
        worst = max(worst, diff.max().item())
        require(torch.isfinite(got).all() and within >= 0.997,
                f"K1 params ({octaves}, {pers}, {freq}): {within:.5f} within {K1_TOL}")
    params = torch.tensor(RAND_PARAM_TABLE[3], dtype=torch.float32, device=DEVICE)
    dev_params = graph_ms(lambda: sx.batched_fractal3_fixed_t_params(seeds, t, hw, params), reps=10)
    pers, freq = float(params[1]), float(params[2])
    dev_static = graph_ms(lambda: sx.batched_fractal3_fixed_t(
        seeds, t, hw, 10, pers, freq), reps=10)
    log(f"K1 parameters-from-device entry: all {len(RAND_PARAM_TABLE)} triples at "
        f"n={BATCH} {hw[0]}x{hw[1]} within rule (worst max|d| {worst:.3e}); at (10, 0.8, "
        f"64) {dev_params:.4f} ms device-only vs the static entry's {dev_static:.4f} ms")

    seed = torch.tensor(12345, device=DEVICE)
    z = NOISE_VOLUME_Z
    vol = sx.fractal3_volume_hash(seed, (z,) + hw, 1, 0.5, 32.0)
    plain = sx._fractal3_fixed_t_plain(seed.reshape(1).expand(z).contiguous(),
                                       torch.arange(z, dtype=torch.float32, device=DEVICE),
                                       hw, 1, 0.5, 32.0)
    within = ((vol - plain).abs() <= K1_TOL).float().mean().item()
    require(within >= 0.997, f"volume: {within:.5f} within {K1_TOL}")
    worst = max(worst, (vol - plain).abs().max().item())
    log(f"simplex volume ({z}, {hw[0]}, {hw[1]}) through K1: {within:.6f} of voxels within "
        f"{K1_TOL} of the plain volume")

    perms, gids = sx.perm_tables(BATCH, gen)
    table = lambda: sx.batched_fractal3_fixed_t_table(perms, gids, t, hw, 6, 0.8, 64.0)
    card = table()
    t0 = time.time()
    cpu = sx.batched_fractal3_fixed_t_table(perms.cpu(), gids.cpu(), t.cpu(), hw,
                                            6, 0.8, 64.0)
    cpu_s = time.time() - t0
    within_t = ((card.cpu() - cpu).abs() <= K1_TOL).float().mean().item()
    table_ms = cuda_ms(table, 5)
    fields2 = lambda: sx.batched_fractal2(seeds, hw, 6, 0.8, 64.0)
    card2 = fields2()
    t0 = time.time()
    cpu2 = sx.batched_fractal2(seeds.cpu(), hw, 6, 0.8, 64.0)
    cpu2_s = time.time() - t0
    within_2 = ((card2.cpu() - cpu2).abs() <= K1_TOL).float().mean().item()
    ms_2 = cuda_ms(fields2, 5)
    require(within_t >= 0.997 and within_2 >= 0.997,
            f"table {within_t:.5f}, 2-D {within_2:.5f} within {K1_TOL} of the CPU")
    log(f"plain PyTorch on the card, n={BATCH} fields of {hw[0]}x{hw[1]}, 6 octaves: "
        f"table path {table_ms:.3f} ms per field batch ({within_t:.6f} within "
        f"{K1_TOL} of the CPU), 2-D hash path {ms_2:.3f} ms ({within_2:.6f}); "
        f"the CPU's calls took {cpu_s:.2f} s and {cpu2_s:.2f} s")
    return worst


def texture_fixtures(root):
    """DATASETS/leather (MVTec: train/good, test/<class>, ground_truth) and
    DATASETS/CARPET/Class1_def (DAGM with labels.txt) at 64 x 64, as PNGs
    written by the port's encoder from a fixed seed."""
    import numpy as np
    from anoddpm_torch.data.datasets import MVTec
    from anoddpm_torch.visualize import encode_png
    rng = np.random.default_rng(64)
    yy, xx = np.mgrid[0:64, 0:64]

    def texture(channels):
        base = np.sin(xx / rng.uniform(2, 5)) * np.cos(yy / rng.uniform(2, 5))
        img = np.stack([base * rng.uniform(40, 80) + 128 + rng.normal(0, 8, base.shape)
                        for _ in range(channels)], -1)
        img = np.clip(img, 0, 255).astype(np.uint8)
        return img[..., 0] if channels == 1 else img

    def put(path, img):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "wb") as f:
            f.write(encode_png(img))

    leather = os.path.join(root, "DATASETS", "leather")
    put(os.path.join(leather, "train", "good", "000.png"), texture(3))
    for cls in MVTec.CLASSES:
        img = texture(3)
        mask = np.zeros((64, 64), np.uint8)
        mask[20:40, 24:44] = 255
        img[mask > 0] = 255 - img[mask > 0]
        put(os.path.join(leather, "test", cls, "000.png"), img)
        put(os.path.join(leather, "ground_truth", cls, "000_mask.png"), mask)
    carpet = os.path.join(root, "DATASETS", "CARPET", "Class1_def")
    for i in (1, 2):
        put(os.path.join(carpet, f"{i}.png"), texture(1))
    with open(os.path.join(carpet, "labels.txt"), "w") as f:
        f.write("1\t12.0\t6.0\t1.2\t32.0\t30.0\n2\t9.0\t7.0\t3.1\t28.0\t36.0\n")


def texture_passes(sites_of):
    """One detection pass each, at 32^2 and lambda = SMALL_T, with exact
    launch counts: the DAGM carpet fixture through
    `anomalous_metric_calculation`, and the MVTec leather fixture (3
    channels) through `evaluate_anomaly_batch` with its (H, W, 1) mask
    repeated over the channels here: the JAX package's metrics and heatmaps
    take a mask of the image's channels, and so do the port's."""
    import numpy as np
    from anoddpm_torch import detect
    from anoddpm_torch.config import defaultdict_from_json
    from anoddpm_torch.data.datasets import anomalous_dataset_from_args
    from anoddpm_torch.models.unet import UNet
    from anoddpm_torch.ops.noise import sampler_from_args
    from anoddpm_torch.schedule import schedule_from_args
    counts = [0] * 5
    lam = min(LAMBDA, SMALL_T)
    with tempfile.TemporaryDirectory() as root:
        texture_fixtures(root)
        for name, channels in (("leather", 3), ("carpet", 1)):
            args = defaultdict_from_json({**small_suite_args(), "dataset": name,
                                          "arg_num": f"small{name}"})
            torch.manual_seed(7)
            model = UNet(img_size=32, base_channels=32, in_channels=channels,
                         channel_mults=(1, 2), attention_resolutions="16").to(DEVICE).eval()
            sched = schedule_from_args(args).to(DEVICE)
            reset_launches()
            if channels == 1:
                summary = detect.anomalous_metric_calculation(
                    args, root_dir=root, em=model, sched=sched, max_volumes=1,
                    t_distance=lam, device=DEVICE)
            else:
                sample = anomalous_dataset_from_args(root, args)[0]
                mask = np.repeat(sample["mask"], channels, axis=-1)
                out, recon = detect.evaluate_anomaly_batch(
                    model, sched, sample["image"], mask,
                    torch.Generator(device=DEVICE).manual_seed(8),
                    sampler_from_args(args), lam)
                require(recon.shape == (1, 32, 32, 3), f"leather recon {recon.shape}")
                summary = {k: float(np.mean(v)) for k, v in out.items()}
            got = torch_launches()
            want = own_order(lam + 1, sites_of(model) * lam, 0)
            log(f"{name} detection pass (32^2, {channels} channel(s), lambda {lam}): "
                f"AUC {summary['auc']:.4f}; launches K1 {got[0]}, K2 {got[1]}, "
                f"K2b {got[2]}")
            require(tuple(got) == want, f"{name}: launches {got} != {want}")
            require(all(math.isfinite(summary[k]) for k in detect.METRIC_NAMES),
                    f"{name}: metrics {summary}")
            counts = [a + b for a, b in zip(counts, got)]
    return counts


class Tee(io.TextIOBase):
    """Writes to `out` and keeps a copy."""

    def __init__(self, out):
        self.out, self.kept = out, io.StringIO()

    def write(self, text):
        self.kept.write(text)
        return self.out.write(text)

    def flush(self):
        self.out.flush()


def train_path(args, k2_per_forward, card, root):
    """`train.train` at full width with only the cuts of TRAIN_CUTS, then a
    RESUME_RECENT leg, both under `root`; exact launch counts per step, the
    restored AdamW state against the saved one, and a steady window of
    train steps."""
    from anoddpm_torch import train, training
    from anoddpm_torch.config import defaultdict_from_json
    from anoddpm_torch.ops.group_norm_silu import BACKWARD_LAUNCHES
    targs = defaultdict_from_json({**args, **TRAIN_CUTS, "skip_test_eval": True})
    iters, epochs = TRAIN_CUTS["iters_per_epoch"], TRAIN_CUTS["EPOCHS"]
    steps = (epochs + 1) * iters
    sweep_t = int(targs["T"])
    log(f"training path: args{CONFIG} at full width (batch "
        f"{targs['Batch_Size']}, {targs['compute_dtype']}, {targs['noise_fn']} "
        f"noise), cut: {TRAIN_CUTS}, skip_test_eval (testing ran in the small "
        f"phase); the purge of periodic checkpoints is patched out so that "
        f"RESUME_RECENT has one to read")

    def expect(counts, n_steps, sweeps, what):
        want = own_order(n_steps, k2_per_forward * (n_steps + sweeps * sweep_t),
                         k2_per_forward * BACKWARD_LAUNCHES * n_steps)
        log(f"{what}: launches K1 {counts[0]}, K2 {counts[1]}, K2b {counts[2]} "
            f"(expected {want}: per step K1 1, K2 {k2_per_forward}, K2b "
            f"{k2_per_forward} x {BACKWARD_LAUNCHES}; K2 {k2_per_forward} per "
            f"forward of the {sweep_t}-step VLB sweep)")
        require(tuple(counts) == want, f"{what}: launch counts {counts} != {want}")

    purge = train.purge_checkpoints
    train.purge_checkpoints = lambda *a, **k: None
    try:
        tee = Tee(sys.stdout)
        reset_launches()
        t0 = time.time()
        with contextlib.redirect_stdout(tee):
            first = train.train(targs, root_dir=root, device=DEVICE)
        torch.cuda.synchronize()
        wall = time.time() - t0
        leg1 = torch_launches()
        expect(leg1, steps, 1, f"leg 1 ({steps} steps, {wall:.1f} s)")
        require(first.step == steps, f"leg 1 took {first.step} steps")
        sweep = re.search(r"VLB sweep ([0-9.]+) s", tee.kept.getvalue())
        require(sweep is not None, "no VLB sweep was printed")
        with open(os.path.join(root, "metrics", f"args{CONFIG}-train.jsonl")) as f:
            record = json.loads(f.readline())
        require(math.isfinite(record["loss"]), f"epoch 0 loss {record['loss']}")
        fresh = train.new_train_state(targs, torch.device(DEVICE))
        epoch = train.restore_train_state(fresh, root, targs, "RESUME_RECENT")
        saved, restored = (training.optimizer_state(s) for s in (first, fresh))
        same = (epoch == epochs and saved.keys() == restored.keys() and all(
            torch.equal(saved[n][k], restored[n][k])
            for n in saved for k in saved[n]) and all(
            torch.equal(a, b) for a, b in zip(first.model.parameters(),
                                              fresh.model.parameters())))
        require(same, "the restored model or AdamW state differs from the "
                "saved one")
        log(f"RESUME_RECENT restored epoch {epoch}: model and AdamW state "
            f"({len(saved)} parameters, step {float(next(iter(saved.values()))['step']):.0f}) "
            f"equal the saved ones")
        del fresh, first
        reset_launches()
        second = train.train(targs, root_dir=root, resume="RESUME_RECENT",
                             device=DEVICE)
        torch.cuda.synchronize()
        leg2 = torch_launches()
        expect(leg2, iters, 0, f"leg 2 (resumed, {iters} steps)")
    finally:
        train.purge_checkpoints = purge
    # the steady rate: more steps of the resumed state on the same batches
    from anoddpm_torch.data.datasets import dataset_from_args
    from anoddpm_torch.data.pipeline import to_nchw
    from anoddpm_torch.ops.noise import sampler_from_args
    from anoddpm_torch.schedule import schedule_from_args
    import numpy as np
    ds = dataset_from_args(ROOT, targs)
    batch = to_nchw(np.stack([ds[i]["image"] for i in range(TRAIN_BATCH)])).to(DEVICE)
    step = training.make_train_step(
        schedule_from_args(targs).to(DEVICE), sampler_from_args(targs),
        max_t=min(int(targs["sample_distance"]), int(targs["T"])))
    gen = torch.Generator(device=DEVICE).manual_seed(9)
    for _ in range(3):
        step(second, batch, gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    for _ in range(STEADY_STEPS):
        metrics = step(second, batch, gen)
    torch.cuda.synchronize()
    step_ms = (time.time() - t0) / STEADY_STEPS * 1e3
    loss = float(metrics["loss"])
    require(math.isfinite(loss), f"train loss {loss}")
    log(f"train step at args{CONFIG}, batch {TRAIN_BATCH} ({card}): "
        f"{step_ms:.3f} ms per step over {STEADY_STEPS} steps = "
        f"{TRAIN_BATCH / step_ms * 1e3:.2f} images/s; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; VLB sweep "
        f"({sweep_t} forwards at batch {TRAIN_BATCH}) {sweep.group(1)} s; "
        f"loss {loss:.5f}")
    return [a + b for a, b in zip(leg1, leg2)]


# The data-parallel, remat, substep, sharded-detection, context-encoder,
# figure and native-oracle phases.
REMAT_POLICIES = (None, "dots", "nothing")
REMAT_STEPS = 5             # timed full-width steps per remat policy
DP_TOL = 1e-5               # W ranks vs one, relative to the largest value
DP_RANKS_TIMEOUT_S = 300    # the gloo ranks' group timeout and join deadline
CE_STEPS = 50               # context-encoder training steps at 256^2
FIG_T = 40                  # the figure phase's schedule length
NATIVE_FIELDS = 4           # table-path fields of 256^2, 6 octaves


# Every (shape, dtype) K2 and K2b launched at since `record_launch_shapes`,
# and those `check_launched_shapes` has held against the plain versions.
LAUNCHED = {"K2": set(), "K2b": set()}
CHECKED = {"K2": set(), "K2b": set()}


def record_launch_shapes():
    """From here on keep the (shape, dtype) of every K2 and K2b launch in
    LAUNCHED: each launch asks its cached argument builder for its shape."""
    from anoddpm_torch.ops import group_norm_silu as gn
    for name, key in (("_launch_args", "K2"), ("_backward_launch_args", "K2b")):
        def recording(shape, dtype, device, real=getattr(gn, name), key=key):
            LAUNCHED[key].add((tuple(shape), dtype))
            return real(shape, dtype, device)
        setattr(gn, name, recording)


def check_launched_shapes(what):
    """K2 and K2b against their plain versions, under `k2_case`'s and
    `k2b_case`'s rules, at every (shape, dtype) they launched at and that
    no earlier call held.  Returns the worst K2 and K2b max|d|."""
    gen = torch.Generator(device=DEVICE).manual_seed(18)
    new = {k: sorted(LAUNCHED[k] - CHECKED[k], key=str) for k in LAUNCHED}
    worst = {"K2": 0.0, "K2b": 0.0}
    for key, cases in new.items():
        for shape, dtype in cases:
            if key == "K2":
                err = k2_case(*k2_inputs(shape, dtype, gen))
            else:
                x, gamma, beta, go, mean, rstd = k2_inputs(shape, dtype, gen,
                                                           backward=True)
                err, _ = k2b_case(x, go, gamma, beta, mean, rstd)
            worst[key] = max(worst[key], err)
            CHECKED[key].add((shape, dtype))
    summary = "; ".join(
        f"{k} at {len(v)} new (shape, dtype), batches "
        f"{sorted({s[0] for s, _ in v})}, sizes {sorted({s[2] for s, _ in v})}"
        f"^2, worst max|d| {worst[k]:.3e}" for k, v in new.items())
    log(f"kernels at the shapes {what} launched, held against plain: {summary}")
    return worst["K2"], worst["K2b"]


def free_port():
    """A TCP port on localhost that nothing listens on now."""
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def small_dp_steps(mesh=None, remat=None, steps=2, device=None):
    """Two fp32 train steps (hybrid loss, prop-t weights, simplex noise) of
    the 32^2 UNet from seeded weights on global batches of 4, TF32 off;
    under a mesh each rank takes its rows and draws for the global batch.
    Returns the losses, each step's clipped gradients, the parameters, the
    EMA and AdamW's moments, on the CPU."""
    import numpy as np
    from anoddpm_torch import schedule, training
    from anoddpm_torch.ops.noise import make_noise_sampler
    device = torch.device(device or (mesh.device if mesh else DEVICE))
    model = small_unet().to(device)
    state = training.init_train_state(
        model, training.make_optimizer(model.parameters(), 1e-4))
    sched = schedule.make_schedule(
        schedule.get_beta_schedule(20, "cosine")).to(device)
    step = training.make_train_step(sched, make_noise_sampler("simplex"),
                                    "hybrid", loss_weight="prop-t",
                                    remat=remat, mesh=mesh)
    gen = torch.Generator(device=device).manual_seed(3)
    rng = np.random.default_rng(4)
    out = {"losses": [], "grads": []}
    with tf32_off():
        for _ in range(steps):
            x = torch.from_numpy(rng.normal(size=(4, 1, 32, 32)).astype(
                np.float32)).to(device)
            m = step(state, x if mesh is None else mesh.shard_batch(x), gen)
            out["losses"].append(float(m["loss"]))
            out["grads"].append([p.grad.detach().cpu().clone()
                                 for p in model.parameters()])
    out["params"] = [p.detach().cpu() for p in model.parameters()]
    out["ema"] = [p.detach().cpu() for p in state.ema.parameters()]
    opt = training.optimizer_state(state)
    out["moments"] = [opt[n][k].cpu() for n, _ in model.named_parameters()
                      for k in ("exp_avg", "exp_avg_sq")]
    return out


def compare_dp_steps(got, want, what):
    """`small_dp_steps` results within DP_TOL: losses relative; gradients,
    EMA and moments against the largest magnitude of their kind; parameters
    against their largest, where every step's gradient exceeds 1e-3 of the
    largest (elsewhere Adam steps by +-lr with a sign set by rounding, and
    is held to 2 lr a step).  Returns the worst relative difference."""
    worst = max(abs(a - b) / abs(b) for a, b in zip(got["losses"], want["losses"]))
    gmax = max(g.abs().max().item() for gs in want["grads"] for g in gs)
    for gs_g, gs_w in zip(got["grads"], want["grads"]):
        worst = max(worst, max((a - b).abs().max().item()
                               for a, b in zip(gs_g, gs_w)) / gmax)
    for kind in ("ema", "moments"):
        scale = max(w.abs().max().item() for w in want[kind])
        worst = max(worst, max((a - b).abs().max().item()
                               for a, b in zip(got[kind], want[kind])) / scale)
    steps = len(want["grads"])
    for i, (a, b) in enumerate(zip(got["params"], want["params"])):
        keep = torch.stack([gs[i].abs() > 1e-3 * gmax
                            for gs in want["grads"]]).all(0)
        d = (a - b).abs()
        require(d.max().item() <= 2 * 1e-4 * steps,
                f"{what}: a parameter moved {d.max().item():.3e} apart")
        if keep.any():
            worst = max(worst, d[keep].max().item() / b.abs().max().item())
    log(f"{what}: worst relative difference {worst:.3e} (rule {DP_TOL})")
    require(worst <= DP_TOL, f"{what}: {worst:.3e} > {DP_TOL}")
    return worst


def _gloo_rank(rank, port, out_path, device):
    """One of two gloo ranks on `device` (a spawned process)."""
    import datetime
    sys.path.insert(0, ROOT)
    from anoddpm_torch.parallel.mesh import close_mesh, init_mesh
    mesh = init_mesh(device, backend="gloo",
                     init_method=f"tcp://localhost:{port}", rank=rank,
                     world_size=2,
                     timeout=datetime.timedelta(seconds=DP_RANKS_TIMEOUT_S))
    record_launch_shapes()
    try:
        out = small_dp_steps(mesh)
        out["launched"] = LAUNCHED
        if mesh.is_main:
            torch.save(out, out_path)
    finally:
        close_mesh(mesh)


def gloo_two_ranks(want):
    """`small_dp_steps` on two gloo ranks sharing the card, each its own
    process, against one process on the card."""
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "rank0.pt")
        t0 = time.time()
        device = "cuda:0" if DEVICE == "cuda" else DEVICE
        ctx = mp.start_processes(_gloo_rank, args=(free_port(), path, device),
                                 nprocs=2, join=False, start_method="spawn")
        deadline = t0 + DP_RANKS_TIMEOUT_S
        try:
            while not ctx.join(timeout=max(deadline - time.time(), 0.1)):
                require(time.time() < deadline,
                        f"2 gloo ranks did not finish in {DP_RANKS_TIMEOUT_S} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
        got = torch.load(path, weights_only=False)
    for key, shapes in got["launched"].items():
        LAUNCHED[key] |= shapes
    log(f"2 gloo ranks on the card (32^2, global batch 4, 2 steps): "
        f"{time.time() - t0:.1f} s with the processes' start")
    compare_dp_steps(got, want, "2 gloo ranks vs 1 process")


def ddp_variant(step_of, state, batch, gen, mesh, **options):
    """A DDP train step whose DistributedDataParallel takes `options`
    (built at its first step, which is taken here)."""
    from anoddpm_torch import training
    real = training.data_parallel
    training.data_parallel = lambda module, mesh_: \
        torch.nn.parallel.DistributedDataParallel(
            module, device_ids=([mesh_.device.index] if mesh_.device.type == "cuda"
                                else None), **options)
    try:
        step = step_of(mesh=mesh)
        step(state, batch, gen)
    finally:
        training.data_parallel = real
    return step


def profile_step(step, state, batch, gen):
    """One step under torch.profiler: its wall ms, self CPU ms by op name,
    device ms of kernels and copies by name (not the device spans of
    record_function ranges), and the NCCL kernels' names."""
    torch.cuda.synchronize()
    t0 = time.time()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        step(state, batch, gen)
        torch.cuda.synchronize()
    wall = (time.time() - t0) * 1e3
    by_name = {a.key: a.self_cpu_time_total / 1e3 for a in prof.key_averages()}
    device = {}
    for e in prof.events():
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and not e.is_user_annotation):
            device[e.name] = device.get(e.name, 0.0) + e.device_time_total / 1e3
    nccl = sorted(k for k in device if "nccl" in k.lower())
    return wall, by_name, device, nccl


def ddp_path(args, k2_per_forward, mesh, card):
    """Data parallel on the card: the NCCL mesh of one rank (the only size
    one card allows) at 32^2 against the plain step; two gloo ranks on the
    card against one; then args256syn128 at batch 8 and full width: the
    plain step, the DDP step and DDP copying the gradients out of its
    buckets (as before the port made them views) timed in turns, with exact kernel launches per step, and one
    profiled step of each split into device time and host time by op (the
    ops where DDP spends more host time than the plain step)."""
    from anoddpm_torch.ops.group_norm_silu import BACKWARD_LAUNCHES
    want = small_dp_steps()
    compare_dp_steps(small_dp_steps(mesh), want, "DDP over NCCL (W = 1) vs plain")
    gloo_two_ranks(want)
    state, batch, step_of = full_width_state(args)
    gen = torch.Generator(device=DEVICE).manual_seed(9)
    steps = {"plain": step_of(), "ddp": step_of(mesh=mesh)}
    steps["ddp_copy"] = ddp_variant(step_of, state, batch, gen, mesh,
                                    gradient_as_bucket_view=False)
    for step in steps.values():
        for _ in range(3):
            step(state, batch, gen)
    times, counts = {k: [] for k in steps}, None
    want_counts = list(own_order(STEADY_STEPS, STEADY_STEPS * k2_per_forward,
                                 STEADY_STEPS * k2_per_forward * BACKWARD_LAUNCHES))
    for name in ("plain", "ddp", "ddp_copy", "ddp_copy", "ddp", "plain"):
        torch.cuda.synchronize()
        before = torch_launches()
        t0 = time.time()
        for _ in range(STEADY_STEPS):
            metrics = steps[name](state, batch, gen)
        torch.cuda.synchronize()
        times[name].append((time.time() - t0) / STEADY_STEPS * 1e3)
        got = [a - b for a, b in zip(torch_launches(), before)]
        if name == "ddp":
            counts = got
        require(math.isfinite(float(metrics["loss"])), f"{name} step: loss")
        require(got == want_counts, f"{name} window launches {got} != {want_counts}")
    profiles = {k: profile_step(v, state, batch, gen) for k, v in steps.items()}
    log(f"DDP step at args{CONFIG}, batch {TRAIN_BATCH}, NCCL W = 1 ({card}; "
        f"{sum(1 for _ in state.model.buffers())} buffers, so broadcast_buffers "
        f"has nothing to send): ms per step over {STEADY_STEPS} steps in turns "
        + ", ".join(f"{k} {' / '.join(f'{t:.3f}' for t in v)}"
                    for k, v in times.items())
        + f"; launches per DDP step K1 {counts[0] // STEADY_STEPS}, K2 "
        f"{counts[1] // STEADY_STEPS}, K2b {counts[2] // STEADY_STEPS}, plus "
        f"NCCL kernels {profiles['ddp'][3]}")
    plain = profiles["plain"]

    def most_extra(got, base, n):
        extra = sorted(((v - base.get(k, 0.0), k) for k, v in got.items()),
                       reverse=True)[:n]
        return ", ".join(f"{k[:60]} {d:+.3f}" for d, k in extra)

    for name in ("ddp", "ddp_copy"):
        wall, by_name, device, _ = profiles[name]
        log(f"profiled {name} step: wall {wall:.3f} ms, kernels and copies "
            f"{sum(device.values()):.3f} ms on the device, self CPU "
            f"{sum(by_name.values()):.3f} ms; plain step wall {plain[0]:.3f} ms, "
            f"device {sum(plain[2].values()):.3f} ms, self CPU "
            f"{sum(plain[1].values()):.3f} ms; the most extra self CPU ms: "
            f"{most_extra(by_name, plain[1], 10)}; the most extra device ms: "
            f"{most_extra(device, plain[2], 8)}")
    del state, steps
    torch.cuda.empty_cache()
    return counts


def full_width_state(args):
    """A fresh args256syn128 train state on the card (seeded init), a batch
    of TRAIN_BATCH synthetic slices, and `step_of(**kw)` making its train
    step."""
    import numpy as np
    from anoddpm_torch import train, training
    from anoddpm_torch.config import defaultdict_from_json
    from anoddpm_torch.data.datasets import dataset_from_args
    from anoddpm_torch.data.pipeline import to_nchw
    from anoddpm_torch.ops.noise import sampler_from_args
    from anoddpm_torch.schedule import schedule_from_args
    targs = defaultdict_from_json(dict(args))
    state = train.new_train_state(targs, torch.device(DEVICE))
    ds = dataset_from_args(ROOT, targs)
    batch = to_nchw(np.stack([ds[i]["image"] for i in range(TRAIN_BATCH)])).to(DEVICE)
    sched = schedule_from_args(targs).to(DEVICE)

    def step_of(**kw):
        return training.make_train_step(
            sched, sampler_from_args(targs),
            max_t=min(int(targs["sample_distance"]), int(targs["T"])), **kw)

    return state, batch, step_of


def remat_path(args, k2_per_forward, card):
    """Each remat policy at 32^2 (fp32, TF32 off) against no remat: the
    losses and gradients of two steps; then at full width (args256syn128,
    batch 8): ms per step, peak memory and K1/K2/K2b launches per step."""
    from anoddpm_torch.ops.group_norm_silu import BACKWARD_LAUNCHES
    want = small_dp_steps()
    for policy in REMAT_POLICIES[1:]:
        compare_dp_steps(small_dp_steps(remat=policy), want,
                         f"remat {policy} vs none (32^2)")
    state, batch, step_of = full_width_state(args)
    gen = torch.Generator(device=DEVICE).manual_seed(9)
    total = [0] * 5
    for policy in REMAT_POLICIES:
        step = step_of(remat=policy)
        for _ in range(2):
            step(state, batch, gen)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch_launches()
        t0 = time.time()
        for _ in range(REMAT_STEPS):
            metrics = step(state, batch, gen)
        torch.cuda.synchronize()
        ms = (time.time() - t0) / REMAT_STEPS * 1e3
        counts = [a - b for a, b in zip(torch_launches(), before)]
        total = [a + b for a, b in zip(total, counts)]
        per = [c // REMAT_STEPS for c in counts]
        want_per = list(own_order(1, k2_per_forward * (1 if policy is None else 2),
                                  k2_per_forward * BACKWARD_LAUNCHES))
        log(f"remat {policy} at args{CONFIG}, batch {TRAIN_BATCH} ({card}): "
            f"{ms:.3f} ms per step over {REMAT_STEPS}; peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches per "
            f"step K1 {per[0]}, K2 {per[1]}, K2b {per[2]} (expected {want_per}); "
            f"loss {float(metrics['loss']):.5f}")
        require(counts == [REMAT_STEPS * w for w in want_per],
                f"remat {policy}: launches {counts}")
        require(math.isfinite(float(metrics["loss"])), f"remat {policy}: loss")
    del state
    torch.cuda.empty_cache()
    return total


def substeps_path(card):
    """args_dptest (32^2, hybrid loss, prop-t, randParam, dropout 0.1, fp32,
    train_substeps 2) through `make_multi_step`: a window of dispatches
    under sync-debug "error" (no host sync anywhere in them), exact
    launches."""
    import numpy as np
    from anoddpm_torch import train, training
    from anoddpm_torch.config import load_args
    from anoddpm_torch.data.datasets import dataset_from_args
    from anoddpm_torch.data.pipeline import to_nchw
    from anoddpm_torch.models.unet import NormSiLU
    from anoddpm_torch.ops.group_norm_silu import BACKWARD_LAUNCHES
    from anoddpm_torch.ops.noise import sampler_from_args
    from anoddpm_torch.schedule import schedule_from_args
    dargs = load_args("args_dptest", config_dir=os.path.join(ROOT, "configs"))
    s, b = int(dargs["train_substeps"]), int(dargs["Batch_Size"])
    state = train.new_train_state(dargs, torch.device(DEVICE))
    sites = sum(isinstance(m, NormSiLU) for m in state.model.modules())
    ds = dataset_from_args(ROOT, dargs)
    batches = to_nchw(np.stack([ds[i]["image"] for i in range(s * b)]).reshape(
        (s, b) + ds[0]["image"].shape)).to(DEVICE)
    step = training.make_multi_step(training.make_train_step(
        schedule_from_args(dargs).to(DEVICE), sampler_from_args(dargs),
        str(dargs["loss-type"]), loss_weight=str(dargs["loss_weight"]),
        dropout=True), s)
    gen = torch.Generator(device=DEVICE).manual_seed(5)
    for _ in range(3):
        step(state, batches, gen)
    torch.cuda.synchronize()
    before = torch_launches()
    t0 = time.time()
    with sync_debug_error():
        for _ in range(STEADY_STEPS):
            metrics = step(state, batches, gen)
    torch.cuda.synchronize()
    ms = (time.time() - t0) / STEADY_STEPS * 1e3
    counts = [a - b for a, b in zip(torch_launches(), before)]
    want = list(own_order(STEADY_STEPS * s, STEADY_STEPS * s * sites,
                          STEADY_STEPS * s * sites * BACKWARD_LAUNCHES))
    log(f"substeps: args_dptest, {s} steps of batch {b} per dispatch ({card}): "
        f"{ms:.3f} ms per dispatch = {s * b / ms * 1e3:.1f} images/s over "
        f"{STEADY_STEPS} dispatches, no host sync; launches {counts} "
        f"(expected {want}); mean loss {float(metrics['loss']):.5f}")
    require(counts == want, f"substeps: launches {counts} != {want}")
    require(math.isfinite(float(metrics["loss"])), "substeps: loss")
    return counts


def sharded_path(model, args, k2_per_forward, mesh):
    """`sharded_anomalous_metrics` at full width over the NCCL mesh of one
    rank on one volume: exact launches (one chunk of 4 slices), finite
    metrics in the CSV, slices/s."""
    from anoddpm_torch import detect
    from anoddpm_torch.schedule import schedule_from_args
    sched = schedule_from_args(args).to(DEVICE)
    with tempfile.TemporaryDirectory() as root:
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.time()
        summary = detect.sharded_anomalous_metrics(args, model, sched, mesh,
                                                   root_dir=root, max_volumes=1)
        torch.cuda.synchronize()
        wall = time.time() - t0
        counts = list(torch_launches())
        with open(os.path.join(root, "metrics", f"args{CONFIG}.csv")) as f:
            csv = f.read().strip()
    want = list(own_order(LAMBDA + 1, k2_per_forward * LAMBDA, 0))
    log(f"sharded detection (NCCL W = 1, 1 volume of {BATCH} slices, lambda "
        f"{LAMBDA}): {wall:.2f} s = {BATCH / wall:.3f} slices/s; launches "
        f"{counts} (expected {want}); csv {csv!r}")
    require(counts == want, f"sharded detection: launches {counts} != {want}")
    require(all(math.isfinite(summary[k]) for k in detect.METRIC_NAMES),
            f"sharded detection: {summary}")
    return counts


def ce_path(args):
    """The context-encoder baseline at 256^2: CE_STEPS training steps on
    the synthetic healthy set, one anomalous volume scored (the CE CSV);
    no K1/K2 launches."""
    from anoddpm_torch import baselines
    with tempfile.TemporaryDirectory() as root:
        reset_launches()
        t0 = time.time()
        model = baselines.train_context_encoder(args, root_dir=root,
                                                steps=CE_STEPS, device=DEVICE)
        torch.cuda.synchronize()
        train_s = time.time() - t0
        t0 = time.time()
        summary, (fpr, tpr, _) = baselines.ce_anomalous_metrics(
            model, args, root_dir=root, max_volumes=1)
        score_s = time.time() - t0
        with open(os.path.join(root, "metrics", f"args{CONFIG}-ce.csv")) as f:
            header = f.readline().strip()
        counts = list(torch_launches())
    log(f"context encoder at 256^2: {CE_STEPS} steps of batch 16 in "
        f"{train_s:.2f} s, 1 volume scored in {score_s:.2f} s (16 inpaintings "
        f"per slice); AUC {summary['auc']:.4f}; csv header {header!r}; "
        f"launches {counts}")
    require(header == "dice,iou,precision,recall,fpr,auc", f"CE csv {header}")
    require(counts == [0] * 5, f"context encoder launched {counts}")
    require(fpr[-1] == 1.0 and tpr[-1] == 1.0, "CE ROC does not end at (1, 1)")
    return counts


def figures_path(writers):
    """Every figure generator, the test-set filmstrips and the CE sheets at
    32^2 (T = FIG_T) on the card from a checkpoint of the small UNet: the
    JAX package's file names under final-outputs/."""
    from anoddpm_torch import baselines, checkpoint, figures
    from anoddpm_torch.config import defaultdict_from_json
    args = defaultdict_from_json({
        **small_suite_args(), "arg_num": "figs", "T": FIG_T,
        "sample_distance": 30, "anomalous_volumes": 2})
    model = small_unet()
    with tempfile.TemporaryDirectory() as root:
        for token in ("figs", "figg"):
            checkpoint.save_checkpoint(root, {**args, "arg_num": token}, 0,
                                       model.state_dict(), model.state_dict(),
                                       {}, final=True)
        reset_launches()
        t0 = time.time()
        fargs, em, sched = figures._load_eval_model(root, "figs", device=DEVICE)
        small = {"ano": dict(n_attempts=1), "masked_comparison": dict(n_volumes=2),
                 "videos": dict(n_volumes=1)}
        for name, fn in figures.GENERATORS.items():
            fn(fargs, em, sched, root_dir=root, **small.get(name, {}))
        figures.test_set_outputs("figs", "figg", root_dir=root, n_attempts=1,
                                 device=DEVICE)
        ce = baselines.train_context_encoder(fargs, root_dir=root, steps=5,
                                             device=DEVICE)
        figures.ce_outputs(fargs, ce, root_dir=root, n_attempts=1)
        torch.cuda.synchronize()
        wall = time.time() - t0
        counts = list(torch_launches())
        got = {p for p in files_under(root) if p.startswith("final-outputs")}
    want = {f"final-outputs/ARGS=figs-{n}.png" for n in (
        "sequence", "masked-comparison", "gauss-vs-simplex",
        "varying-frequency", "gauss-varyingT")}
    want |= {f"final-outputs/ARGS=figs/{n}" for n in (
        "attempt=1-0.5-predictions.png", "attempt=1-0.5-sequence.png",
        "test_set_mixed_attempt=1-sequence.png", "ce-attempt=1-predictions.png")}
    if writers["videos"]:
        want.add("final-outputs/ARGS=figs-video-0.video")
    log(f"figures at 32^2 (T {FIG_T}): {wall:.1f} s, {len(got)} files, the JAX "
        f"package's names; launches K1 {counts[0]}, K2 {counts[1]}, K2b "
        f"{counts[2]}")
    require(got == want, f"figures: got {sorted(got ^ want)} differently")
    require(counts[0] > 0 and counts[1] > 0 and counts[2] == 0
            and not any(counts[3:]), f"figures: launches {counts}")
    return counts


def native_path():
    """The host C++ oracle built by g++ here, holding the table-path field
    on the card: NATIVE_FIELDS fields of 256^2, 6 octaves, against the
    oracle's float64 fields from the same tables, by the rule the JAX
    package holds its own table path to (tests/test_native.py): median
    |d| < 1e-6 and >= 99% of pixels within 1e-4."""
    import numpy as np
    from anoddpm_torch.ops import native
    from anoddpm_torch.ops import simplex as sx
    t0 = time.time()
    path = native.build()
    build_s = time.time() - t0
    gen = torch.Generator(device=DEVICE).manual_seed(17)
    perms, gids = sx.perm_tables(NATIVE_FIELDS, gen)
    t = torch.tensor([0.0, 57.0, 123.0, 199.0], device=DEVICE)[:NATIVE_FIELDS]
    got = sx.batched_fractal3_fixed_t_table(perms, gids, t, (256, 256), 6,
                                            0.8, 64.0).cpu().numpy()
    perms, gids, t = perms.cpu().numpy(), gids.cpu().numpy(), t.cpu().numpy()
    t0 = time.time()
    err = np.stack([np.abs(got[i] - native.fractal_fixed_t(
        (256, 256), float(t[i]), 6, 0.8, 64.0, perms[i], gids[i]))
        for i in range(NATIVE_FIELDS)])
    oracle_s = time.time() - t0
    med, within = float(np.median(err)), float((err < 1e-4).mean())
    log(f"native oracle: built {os.path.basename(path)} in {build_s:.2f} s; "
        f"{NATIVE_FIELDS} table-path fields on the card vs float64 oracle "
        f"({oracle_s:.2f} s on the host): median |d| {med:.2e}, "
        f"{within * 100:.3f}% within 1e-4, {float((err < 1e-5).mean()) * 100:.2f}% "
        f"within 1e-5, max {err.max():.2e}")
    require(med < 1e-6 and within >= 0.99, "native oracle: table path differs")


# The quality campaign at a cut depth: args256syn128 at full width with only
# EPOCHS, iters_per_epoch, the anomalous volumes and the schedule's length T
# (1,000 -> 400: the VLB sweep and the test-set suite run T and 1.5 T
# forwards; lambda = 200 still fits) cut, the test-set suite at
# CAMPAIGN_TEST_IMAGES images and the figures off.
CAMPAIGN_TOKEN = "campaign"
CAMPAIGN_CUTS = {"EPOCHS": 2, "iters_per_epoch": 4, "anomalous_volumes": 1,
                 "T": 400}
CAMPAIGN_TEST_IMAGES = 4


def counted(calls, stage_of, fn):
    """`fn` that appends (stage_of(args, kwargs), wall seconds, its (K1, K2,
    K2b) launches) to `calls` at each call."""
    def wrapper(*a, **k):
        torch.cuda.synchronize()
        before, t0 = torch_launches(), time.time()
        out = fn(*a, **k)
        torch.cuda.synchronize()
        calls.append((stage_of(a, k), time.time() - t0,
                      tuple(x - y for x, y in zip(torch_launches(), before))))
        return out
    return wrapper


def campaign_path(k2_per_forward, card):
    """`campaigns.flagship.run` under a directory in build/: every stage
    runs with exact launches (per train step, per DDPM-200 and DDIM-15
    volume group, for the test-set suite); a second run skips every stage
    (no train call, no launch); a third at one epoch more resumes from
    params-final (RESUME_FINAL) and scores DDIM-15 again."""
    import numpy as np
    from anoddpm_torch.campaigns import flagship
    from anoddpm_torch.campaigns._results import FLAGSHIP, load_results
    from anoddpm_torch.ops.group_norm_silu import BACKWARD_LAUNCHES
    calls = []
    real = {n: getattr(flagship, n) for n in
            ("train", "anomalous_metric_calculation", "testing")}
    flagship.train = counted(calls, lambda a, k: f"train {k.get('resume')}",
                             real["train"])
    flagship.anomalous_metric_calculation = counted(
        calls, lambda a, k: str(k["args"]["sampler"]),
        real["anomalous_metric_calculation"])
    flagship.testing = counted(calls, lambda a, k: "testing", real["testing"])
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    iters, epochs = CAMPAIGN_CUTS["iters_per_epoch"], CAMPAIGN_CUTS["EPOCHS"]
    try:
        with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build"),
                                         prefix="campaign-") as root:
            with open(os.path.join(ROOT, "configs", f"args{CONFIG}.json")) as f:
                cfg = {**json.load(f), **CAMPAIGN_CUTS}
            os.makedirs(os.path.join(root, "configs"))
            with open(os.path.join(root, "configs",
                                   f"args{CAMPAIGN_TOKEN}.json"), "w") as f:
                json.dump(cfg, f)
            runs = []
            for extra in ({}, {}, {"epochs": epochs + 1, "skip_testing": True,
                                   "protocols": ["ddim15_eta1"]}):
                calls.clear()
                reset_launches()
                t0 = time.time()
                flagship.run(root_dir=root, token=CAMPAIGN_TOKEN,
                             skip_figures=True,
                             test_images=CAMPAIGN_TEST_IMAGES, device=DEVICE,
                             **extra)
                torch.cuda.synchronize()
                runs.append((list(calls), time.time() - t0, torch_launches()))
            res = load_results(root, FLAGSHIP)
    finally:
        for n, fn in real.items():
            setattr(flagship, n, fn)
    sweep_t = int(cfg["T"])
    t_half = sweep_t // 2

    def per_step(n):
        return own_order(n, k2_per_forward * n,
                         k2_per_forward * BACKWARD_LAUNCHES * n)

    first = {s: (w, c) for s, w, c in runs[0][0]}
    steps = (epochs + 1) * iters
    want = {
        "train None": tuple(a + b for a, b in zip(
            per_step(steps), own_order(0, k2_per_forward * sweep_t, 0))),
        "ddpm": own_order(LAMBDA + 1, k2_per_forward * LAMBDA, 0),
        "ddim": own_order(15 + 1, k2_per_forward * 15, 0),
        "testing": own_order(t_half + 1, k2_per_forward * (sweep_t + t_half),
                             0)}
    for stage, counts in want.items():
        require(stage in first, f"campaign: stage {stage} did not run")
        log(f"campaign stage {stage}: {first[stage][0]:.1f} s, launches K1 "
            f"{first[stage][1][0]}, K2 {first[stage][1][1]}, K2b "
            f"{first[stage][1][2]} (expected {counts})")
        require(first[stage][1] == counts,
                f"campaign {stage}: launches {first[stage][1]} != {counts}")
    log(f"campaign: per train step K1 1, K2 {k2_per_forward}, K2b "
        f"{k2_per_forward * BACKWARD_LAUNCHES}; the train stage adds the "
        f"{sweep_t}-forward VLB sweep of epoch 0")
    require(runs[1][0] == [] and runs[1][2] == (0,) * 5,
            f"campaign rerun: calls {runs[1][0]}, launches {runs[1][2]}")
    third = {s: (w, c) for s, w, c in runs[2][0]}
    want3 = {"train RESUME_FINAL": per_step(2 * iters),
             "ddim": own_order(15 + 1, k2_per_forward * 15, 0)}
    require(sorted(third) == sorted(want3), f"campaign extension: {sorted(third)}")
    for stage, counts in want3.items():
        require(third[stage][1] == counts,
                f"campaign extension {stage}: {third[stage][1]} != {counts}")
    keys = {"train_epochs", f"train_seconds@{epochs}", f"train_slice@{epochs}",
            f"train_seconds@{epochs + 1}", f"train_slice@{epochs + 1}",
            f"flagship_ddpm200@{epochs}", f"flagship_ddim15_eta1@{epochs}",
            f"flagship_ddim15_eta1@{epochs + 1}", f"testing@{epochs}"}
    require(set(res) == keys, f"campaign results: {sorted(set(res) ^ keys)}")
    require(res[f"train_slice@{epochs + 1}"] == [epochs, epochs + 1],
            f"campaign extension slice {res[f'train_slice@{epochs + 1}']}")
    values = [v for k in keys if k.startswith(("flagship_", "testing@"))
              for v in res[k].values()]
    require(all(np.isfinite(values)), "campaign: non-finite results")
    log(f"campaign ({card}): run 1 {runs[0][1]:.1f} s (every stage), run 2 "
        f"{runs[1][1]:.2f} s (every stage skipped, no launch), run 3 "
        f"{runs[2][1]:.1f} s ({epochs} -> {epochs + 1} epochs, RESUME_FINAL, "
        f"{third['train RESUME_FINAL'][0]:.1f} s of training, DDIM-15 "
        f"{third['ddim'][0]:.1f} s); DDPM-200 AUC "
        f"{res[f'flagship_ddpm200@{epochs}']['auc']:.4f} after {steps} steps")
    return [a + b for a, b in zip(runs[0][2], runs[2][2])]


# The s2d64 campaigns at a cut depth: args256syn64s2d at full width (256^2
# images through a space-to-depth of 2 into a 128^2 UNet of base 64, bf16,
# batch 8; 2 channels per GroupNorm group at the top level) with only
# EPOCHS, iters_per_epoch, the anomalous volumes and T (1,000 -> 400: the
# VLB sweeps and the dense sweep's lambdas) cut and the test-set suite off;
# the diffuse calibration at 2 severities, the dense sweep at every
# S2D64_LAMBDA_STEP-th lambda (one chunk).
S2D64_CONFIG = "256syn64s2d"
S2D64_SEED = 1
S2D64_CUTS = {"EPOCHS": 2, "iters_per_epoch": 8, "anomalous_volumes": 1,
              "skip_test_eval": True, "T": 400}
S2D64_SEVERITIES = (1.0, 2.0)
S2D64_LAMBDA_STEP = 250
# the seeds route (`seed_replication.run S --skip=paper128`): one more seed
# trained for one epoch of one dispatch, scored in the 9 s2d64 cells
S2D64_SEEDS_SEED = 2
S2D64_SEEDS_CUTS = {"EPOCHS": 0}
S2D64_SEEDS_SKIP = ("paper128",)


def s2d64_kernel_times(model):
    """Device-only ms of K2 per UNet forward at the detection batch and of
    K2b per train step at the training batch, at `model`'s sites, each
    beside its bytes bound, with the top-level site's own share.  Returns
    the number of K2 sites per forward."""
    from anoddpm_torch.ops import group_norm_silu as gn
    gen = torch.Generator(device=DEVICE).manual_seed(19)
    for n, key in ((BATCH, "K2"), (TRAIN_BATCH, "K2b")):
        sites, timing = k2_sites(model, n), {}
        for shape, dtype in set(sites):
            if key == "K2":
                x, gamma, beta = k2_inputs(shape, dtype, gen)
                fn = lambda: gn.group_norm_silu(x, gamma, beta)
                nbytes = 2 * x.numel() * x.element_size()
            else:
                x, gamma, beta, go, mean, rstd = k2_inputs(shape, dtype, gen,
                                                           backward=True)
                fn = lambda: gn.group_norm_silu_backward(x, go, gamma, beta,
                                                         mean, rstd)
                nbytes = (3 * x.numel() * x.element_size() + 4 * shape[1] * 4
                          + 2 * n * 32 * 4)
            timing[(shape, dtype)] = (graph_ms(fn, reps=10),
                                      nbytes / HBM_BYTES_PER_S * 1e3)
        dev = sum(timing[s][0] for s in sites)
        bound = sum(timing[s][1] for s in sites)
        top = [s for s in timing if s[0][2] == max(t[0][2] for t in timing)]
        log(f"{key} at the s2d64 sites, N={n} ({len(sites)} calls per "
            f"{'forward' if key == 'K2' else 'train step'}): {dev:.3f} ms "
            f"device-only, bound {bound:.3f} ms ({bound / dev:.1%} of it); "
            "top level " + ", ".join(
                f"{s[0]} {str(s[1])[6:]} {timing[s][0]:.4f} ms vs "
                f"{timing[s][1]:.4f} ({timing[s][1] / timing[s][0]:.1%})"
                for s in sorted(top, key=str)))
    return len(sites)


def s2d64_path(card):
    """The s2d64 campaigns under a directory in build/: seed 1 trained by
    `seed_replication.ensure_trained`, `diffuse_calibration.run`,
    `train_longer.run` (extended by one epoch through RESUME_FINAL and
    scored in its three protocols) and `dense_sweep.run` on that model
    (its train gate skips), each call with exact launches; then all of
    them again, which call and launch nothing.  Then the seeds route under
    another directory: `seed_replication.run` of one seed with the paper
    cells skipped trains args256syn64s2d alone (one epoch) and scores the 9
    s2d64 cells, each call with exact launches; a rerun calls and launches
    nothing.  Returns the (K1, K2, K2b) launches."""
    import numpy as np
    from anoddpm_torch.campaigns import (_stages, dense_sweep,
                                         diffuse_calibration,
                                         seed_replication, train_longer)
    from anoddpm_torch.campaigns._results import (DENSE_SWEEP,
                                                  DIFFUSE_CALIBRATION,
                                                  SEED_REPLICATION,
                                                  TRAIN_LONGER, load_results)
    from anoddpm_torch.config import load_args
    from anoddpm_torch.ops.group_norm_silu import BACKWARD_LAUNCHES
    t_phase = time.time()
    args = load_args(S2D64_CONFIG, config_dir=os.path.join(ROOT, "configs"))
    args.update(S2D64_CUTS)
    model = seeded_model(args)
    k2 = s2d64_kernel_times(model)
    del model
    torch.cuda.empty_cache()
    token = f"{S2D64_CONFIG}_s{S2D64_SEED}"
    epochs, sweep_t = S2D64_CUTS["EPOCHS"], int(args["T"])
    per_epoch = seed_replication.SUBSTEPS * max(
        S2D64_CUTS["iters_per_epoch"] // seed_replication.SUBSTEPS, 1)
    calls = []

    def cell_stage(p):
        """The stage name of a seed-replication cell from its protocol."""
        return (f"cell {p['sampler']}{p.get('ddim_steps', '')}"
                f"x{int(p.get('recon_repeats') or 1)}"
                + (" diffuse" if p.get("lesion_kind") == "diffuse" else ""))

    wrapped = {
        (seed_replication, "train"): lambda a, k: "train",
        (seed_replication, "anomalous_metric_calculation"):
            lambda a, k: cell_stage(k["args"]),
        (train_longer, "train"): lambda a, k: f"extend {k['resume']}",
        (_stages, "anomalous_metric_calculation"): lambda a, k:
            f"diffuse {k['args']['lesion_severity']:g}"
            if k["args"].get("lesion_kind") == "diffuse" else
            f"longer {k['args']['sampler']}{k['args'].get('ddim_steps', '')}",
        (dense_sweep, "train"): lambda a, k: "dense train",
        (dense_sweep, "graph_data"): lambda a, k: "graph"}
    real = {key: getattr(*key) for key in wrapped}
    for (mod, name), stage_of in wrapped.items():
        setattr(mod, name, counted(calls, stage_of, real[(mod, name)]))
    lambdas = list(range(0, sweep_t, S2D64_LAMBDA_STEP))

    def campaigns():
        seed_replication.ensure_trained(S2D64_CONFIG, S2D64_SEED, root, DEVICE)
        diffuse_calibration.run(S2D64_SEVERITIES, root, token, DEVICE)
        train_longer.run(S2D64_SEED, epochs + 1, root, DEVICE)
        dense_sweep.run(S2D64_LAMBDA_STEP, 1, root, token, DEVICE)

    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    try:
        with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build"),
                                         prefix="s2d64-") as root:
            os.makedirs(os.path.join(root, "configs"))
            # the dense sweep's gate reads the epochs of the model it
            # reuses from that model's config
            for name, seed in ((S2D64_CONFIG, args["seed"]), (token, S2D64_SEED)):
                with open(os.path.join(root, "configs", f"args{name}.json"),
                          "w") as f:
                    json.dump({**args, "seed": seed}, f)
            runs = []
            for _ in range(2):
                calls.clear()
                reset_launches()
                t0 = time.time()
                campaigns()
                torch.cuda.synchronize()
                runs.append((list(calls), time.time() - t0, torch_launches()))
            res = {name: load_results(root, name)
                   for name in (DIFFUSE_CALIBRATION, TRAIN_LONGER, DENSE_SWEEP)}
            extended, _, _ = _stages.train_gate(
                root, train_longer.target_token(S2D64_SEED, epochs + 1),
                epochs + 1)
            with open(os.path.join(root, "metrics",
                                   f"args{token}-lambda.csv")) as f:
                pooled = [line.split(",") for line in f.read().split()[1:]]
        with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build"),
                                         prefix="s2d64-seeds-") as root:
            os.makedirs(os.path.join(root, "configs"))
            with open(os.path.join(root, "configs",
                                   f"args{S2D64_CONFIG}.json"), "w") as f:
                json.dump({**args, **S2D64_SEEDS_CUTS}, f)
            seeds_runs = []
            for _ in range(2):
                calls.clear()
                reset_launches()
                t0 = time.time()
                seed_replication.run([S2D64_SEEDS_SEED], S2D64_SEEDS_SKIP,
                                     root, DEVICE)
                torch.cuda.synchronize()
                seeds_runs.append((list(calls), time.time() - t0,
                                   torch_launches()))
            seeds_res = load_results(root, SEED_REPLICATION)
    finally:
        for (mod, name), fn in real.items():
            setattr(mod, name, fn)

    def step_counts(steps):
        return own_order(steps, k2 * steps, k2 * BACKWARD_LAUNCHES * steps)

    steps = (epochs + 1) * per_epoch
    want = [("train", tuple(a + b for a, b in zip(
        step_counts(steps), own_order(0, k2 * sweep_t, 0))))]
    want += [(f"diffuse {s:g}", own_order(16, k2 * 15, 0))
             for s in S2D64_SEVERITIES]
    want += [("extend RESUME_FINAL", step_counts(2 * per_epoch)),
             ("longer ddim25", own_order(26, k2 * 25, 0)),
             ("longer ddim15", own_order(16, k2 * 15, 0)),
             ("longer ddpm", own_order(LAMBDA + 1, k2 * LAMBDA, 0)),
             ("graph", own_order(1 + max(lambdas), k2 * max(lambdas), 0))]
    got = [(stage, c) for stage, _, c in runs[0][0]]
    for (stage, wall, c), (_, expected) in zip(runs[0][0], want):
        log(f"s2d64 stage {stage}: {wall:.1f} s, launches K1 {c[0]}, K2 "
            f"{c[1]}, K2b {c[2]} (expected {expected})")
    require(got == want, f"s2d64 launches: {got} != {want}")
    log(f"s2d64: per train step K1 1, K2 {k2}, K2b {k2 * BACKWARD_LAUNCHES} "
        f"({k2} K2 sites per s2d64 forward); the first train call adds the "
        f"{sweep_t}-forward VLB sweep of epoch 0")
    require(runs[1][0] == [] and runs[1][2] == (0,) * 5,
            f"s2d64 rerun: calls {runs[1][0]}, launches {runs[1][2]}")

    def cell_counts(p):
        repeats, n = int(p.get("recon_repeats") or 1), int(p.get("ddim_steps", LAMBDA))
        return own_order(repeats * (n + 1), repeats * k2 * n, 0)

    cells = seed_replication.kept_cells(S2D64_CONFIG, S2D64_SEEDS_SKIP)
    order = [c for _, _, c, _ in seed_replication.work_list(
        {}, [S2D64_SEEDS_SEED], S2D64_SEEDS_SKIP)]
    require(len(cells) == 9 and sorted(order) == sorted(cells),
            f"seeds route cells {order}")
    seeds_steps = (S2D64_SEEDS_CUTS["EPOCHS"] + 1) * per_epoch
    seeds_want = [("train", tuple(a + b for a, b in zip(
        step_counts(seeds_steps), own_order(0, k2 * sweep_t, 0))))]
    seeds_want += [(cell_stage(seed_replication.PROTOCOLS[c]),
                    cell_counts(seed_replication.PROTOCOLS[c])) for c in order]
    got = [(stage, c) for stage, _, c in seeds_runs[0][0]]
    for (stage, wall, c), (_, expected) in zip(seeds_runs[0][0], seeds_want):
        log(f"s2d64 seeds stage {stage}: {wall:.1f} s, launches K1 {c[0]}, "
            f"K2 {c[1]}, K2b {c[2]} (expected {expected})")
    require(got == seeds_want, f"s2d64 seeds launches: {got} != {seeds_want}")
    require(seeds_runs[1][0] == [] and seeds_runs[1][2] == (0,) * 5,
            f"s2d64 seeds rerun: calls {seeds_runs[1][0]}, launches "
            f"{seeds_runs[1][2]}")
    want_keys = {f"{c}/{k}" for c in cells
                 for k in (f"seed{S2D64_SEEDS_SEED}", "aggregate")}
    require(set(seeds_res) == want_keys,
            f"seeds route results {sorted(set(seeds_res) ^ want_keys)}")
    require(all(seeds_res[f"{c}/aggregate"][m]["n"] == 1 for c in cells
                for m in seed_replication.METRICS), "seeds route aggregates")
    require(all(np.isfinite(v) for c in cells
                for v in seeds_res[f"{c}/seed{S2D64_SEEDS_SEED}"].values()),
            "seeds route: non-finite results")
    diffuse = res[DIFFUSE_CALIBRATION]
    require(sorted(diffuse) == sorted(diffuse_calibration.key(s)
                                      for s in S2D64_SEVERITIES),
            f"diffuse calibration keys {sorted(diffuse)}")
    longer = res[TRAIN_LONGER]
    require(sorted(longer) == sorted(
        train_longer.result_key(c, S2D64_SEED, epochs + 1)
        for c in train_longer.PROTOCOLS), f"train_longer keys {sorted(longer)}")
    require(extended == epochs + 1, f"extended model records {extended} epochs")
    dense = res[DENSE_SWEEP]
    require(sorted(dense) == ["csv_files", "lambda_step", "sweep_seconds",
                              "volumes"] and len(dense["csv_files"]) == 1,
            f"dense sweep results {dense}")
    require([int(r[0]) for r in pooled] == lambdas, f"pooled rows {pooled}")
    # lambda = 0 leaves the slice as it is: SSIM 1, AUC 0.5, Dice ~0
    ssim0, auc0 = float(pooled[0][2]), float(pooled[0][4])
    require(abs(ssim0 - 1) <= 1e-6 and auc0 == 0.5 and float(pooled[0][1]) < 1e-3,
            f"pooled lambda = 0 row {pooled[0]}")
    values = [v for r in (diffuse, longer) for e in r.values()
              for v in e.values()] + [float(v) for r in pooled for v in r]
    require(all(np.isfinite(values)), "s2d64: non-finite results")
    log(f"s2d64 ({card}): run 1 {runs[0][1]:.1f} s, rerun {runs[1][1]:.2f} s "
        f"(no call, no launch); seeds route (seed {S2D64_SEEDS_SEED}, "
        f"{len(cells)} cells) {seeds_runs[0][1]:.1f} s, rerun "
        f"{seeds_runs[1][1]:.2f} s (no call, no launch); DDIM-15 AUC "
        f"{seeds_res[f's2d64_ddim15_eta1/seed{S2D64_SEEDS_SEED}']['auc']:.4f}; "
        f"the phase {time.time() - t_phase:.1f} s; "
        f"pooled lambda = 0 row (t, dice, ssim, iou, auc) {pooled[0]}; "
        f"diffuse AUC " + ", ".join(
            f"sev {s:g} {diffuse[diffuse_calibration.key(s)]['auc']:.4f}"
            for s in S2D64_SEVERITIES))
    return [a + b for a, b in zip(runs[0][2], seeds_runs[0][2])]


# Phase 17, the measuring entry points (anoddpm_torch.bench and the
# campaigns chain_flops, mfu_push, bf16_norm_ab, substep_probe) at quick
# sizes, and the JAX package's norm composition (`norm_impl="flax"`).
MEASURE_IMG = 256            # the image size of every model of the phase
MEASURE_REPEATS = 2          # timed chains per bench cell, after a warm-up
MEASURE_BATCH = 4            # the bench's quick batch (BENCH_QUICK)
MEASURE_LAMBDA = 50          # the bench's quick lambda
MEASURE_TIMING_REPS = 5      # timed forwards / train steps per norm path
NORM_PATHS = {"kernel": dict(norm_impl="kernel"),
              "flax_fp32": dict(norm_impl="flax", bf16_norm=False),
              "flax_bf16": dict(norm_impl="flax", bf16_norm=True)}
# A flax-order site on the card (K2 and K2b in their flax order) against the
# plain composition on the CPU (reductions in another order).  The GroupNorm
# output h rounds once, as K2's does: K2's rule (fp32 and bf16), so h may
# sit one bf16 ulp apart, which SiLU carries as at most 1.1 ulps; one of
# SiLU's per-op roundings (exp, 1 + exp, the reciprocal) going the other
# way moves the output by at most 2 ulps of max(|h|, |out|), by enumeration
# over every bf16 h.  The output: in bf16 within 4 ulps of max(|h|, |out|)
# (1e-4 floor) and bit-equal in >= 99% of elements, in fp32 K2's rule.  dx:
# bit-equal in >= 99% of elements, and within 4 bf16 ulps of its largest
# magnitude (bf16: an element whose h or SiLU intermediate sits an ulp
# apart carries up to 3 ulps into its gradient), 1e-4 of it (fp32); dgamma,
# dbeta, sums of per-element gradients that the bf16 SiLU backward rounds
# op by op: one bf16 ulp of their largest magnitude (bf16), K2b's 1e-4
# (fp32); the statistics K2's 1e-5; two backward runs bit-identical.
FLAX_SITE_OUT_ULPS = 4
FLAX_SITE_EQUAL = 0.99
FLAX_SITE_DX_TOL = {torch.float32: K2B_TOL, torch.bfloat16: 2 ** -5}
FLAX_SITE_PARAM_TOL = {torch.float32: K2B_TOL, torch.bfloat16: 2 ** -7}
# The substep probe's cut: 1 epoch (+ epoch 0) of 8 iterations and a
# schedule of 100 steps (the epoch-0 VLB sweep's length), args256syn128's
# widths otherwise.
SUBSTEP_SETTINGS = (4, 8)
SUBSTEP_CUTS = {"T": 100}


def counted_launches(what, fn, want, total):
    """fn() with the launches it makes (`torch_launches`) required to equal
    `want`, added to `total`; returns fn()'s result."""
    torch.cuda.synchronize()
    before = torch_launches()
    out = fn()
    torch.cuda.synchronize()
    got = [a - b for a, b in zip(torch_launches(), before)]
    require(got == list(want), f"{what}: launches {got} != {list(want)}")
    total[:] = [a + b for a, b in zip(total, got)]
    return out


def site_count(**unet_kwargs):
    """norm+SiLU sites of a UNet (built on the meta device)."""
    from anoddpm_torch.models.unet import NormSiLU, UNet
    with torch.device("meta"):
        model = UNet(**unet_kwargs)
    return sum(isinstance(m, NormSiLU) for m in model.modules())


def flax_pass(model, batch, grad):
    """One forward of `model` on seeded input at `batch`, under `grad`
    with a backward against a seeded output gradient."""
    gen = torch.Generator(device=DEVICE).manual_seed(21)
    x = torch.randn((batch, 1, MEASURE_IMG, MEASURE_IMG), generator=gen,
                    device=DEVICE)
    t = torch.randint(0, 1000, (batch,), generator=gen, device=DEVICE)
    if grad:
        out = model(x, t)
        out.backward(torch.randn(out.shape, generator=gen, device=DEVICE))
        model.zero_grad(set_to_none=True)
    else:
        with torch.inference_mode():
            out = model(x, t)
    require(bool(torch.isfinite(out).all()), "flax path: non-finite output")


def flax_site_case(shape, dtype, bf16_path, gen):
    """K2 and K2b in the flax order at one site on the card, through their
    wrappers, against the plain composition on the CPU (`FLAX_SITE_*`'s
    rules): (output max|d|, its share bit-equal, dx max|d| / max|dx|, dx's
    share bit-equal)."""
    from anoddpm_torch.ops import group_norm_silu as gn
    what = f"flax order {shape} {dtype} bf16_path={bf16_path}"
    c = shape[1]
    x = (torch.randn(shape, generator=gen, device=DEVICE) * 1.7 + 0.4).to(dtype)
    gamma = 1 + 0.1 * torch.randn(c, generator=gen, device=DEVICE)
    beta = 0.1 * torch.randn(c, generator=gen, device=DEVICE)
    go = torch.randn(shape, generator=gen, device=DEVICE).to(dtype)
    out, mean, rstd = gn.group_norm_silu_with_stats(x, gamma, beta, order="flax")
    back = [gn.group_norm_silu_backward(x, go, gamma, beta, mean, rstd,
                                        order="flax", bf16_path=bf16_path)
            for _ in range(2)]
    torch.cuda.synchronize()
    require(all(torch.equal(a, b) for a, b in zip(*back)),
            f"{what}: two backward runs differ")
    xc, gc, bc, goc = (t.cpu() for t in (x, gamma, beta, go))
    want, wmean, wrstd = gn._plain_flax(xc, gc, bc, 1e-5)
    norm = gn._flax_site(xc, gc, bc, False, False).float()
    wdx, wdg, wdb = gn._plain_flax_backward(xc, goc, gc, bc, bf16_path, 1e-5)
    stats_err = max((mean.cpu() - wmean).abs().max().item(),
                    (rstd.cpu() - wrstd).abs().max().item())
    require(stats_err <= K2_STATS_TOL, f"{what}: mean/rstd off by {stats_err:.3e}")
    got, want = out.float().cpu(), want.float()
    diff = (got - want).abs()
    same = (got == want).float().mean().item()
    if dtype == torch.float32:
        ok = (diff <= K2_TOL + K2_TOL * want.abs()).all().item()
    else:
        ref = torch.maximum(norm.abs(), want.abs())
        ok = ((diff <= torch.clamp(FLAX_SITE_OUT_ULPS * bf16_ulp(ref), min=K2_TOL)
               ).all().item() and same >= FLAX_SITE_EQUAL)
    require(ok, f"{what}: output max|d| {diff.max().item():.3e}, bit-equal "
            f"{same:.4f}")
    dx, wdx = back[0][0].float().cpu(), wdx.float()
    dx_err = ((dx - wdx).abs().max() / wdx.abs().max()).item()
    dx_same = (dx == wdx).float().mean().item()
    require(dx_err <= FLAX_SITE_DX_TOL[dtype] and (
        dtype == torch.float32 or dx_same >= FLAX_SITE_EQUAL),
            f"{what}: dx {dx_err:.3e}, bit-equal {dx_same:.4f}")
    for name, g, w in (("dgamma", back[0][1], wdg), ("dbeta", back[0][2], wdb)):
        err = ((g.cpu() - w).abs().max() / w.abs().max()).item()
        require(err <= FLAX_SITE_PARAM_TOL[dtype], f"{what}: {name} {err:.3e}")
    return diff.max().item(), same, dx_err, dx_same


def flax_table_check():
    """The flax order's tables on the card (K2's s(h), K2b's (s, ds)) against
    the device functions they replace, at all 65,536 bf16 values of h, bit
    for bit; and the card's own count of the h where (s, ds) is none of the
    three constants (1/2, 1/4), (1, 0), (0, 0), all of which must lie in the
    table's range |h| in [2^-8, 2^7).  Returns that count."""
    from anoddpm_torch.ops import group_norm_silu as gn
    probe = gn.flax_table_probe(0)
    for key, (table, direct) in probe.items():
        bad = int((table != direct).sum())
        require(bad == 0, f"flax table {key}: {bad} of 65,536 h differ from "
                          "the direct computation")
    bits = torch.arange(65536, dtype=torch.int32, device=DEVICE)
    words = probe["s_ds"][1]
    s = (words & -65536).view(torch.float32)
    ds = (words << 16).view(torch.float32)
    h = (bits << 16).view(torch.float32)
    const = (((s == 0.5) & (ds == 0.25)) | ((s == 1) & (ds == 0))
             | ((s == 0) & (ds == 0)) | torch.isnan(h))
    e = bits & 0x7FFF
    inside = (e >= 119 << 7) & (e < 134 << 7)
    varying = int((~const).sum())
    require(bool((inside | const).all()),
            "flax table: a varying (s, ds) outside |h| in [2^-8, 2^7)")
    top = h[~const].abs().max().item()
    log(f"flax table on the card: K2's s(h) and K2b's (s, ds) bit-equal to "
        f"the device functions at all 65,536 bf16 h; {varying} h with (s, ds) "
        f"off the three constants (2,916 on the CPU), |h| up to {top}")
    return varying


def flax_order_times(sites_of):
    """The flax order of K2 per UNet forward at the detection batch and of
    K2b per train step at the training batch, at each config's sites in
    `sites_of`: back to back and device-only, beside the plain composition's
    own time on the card (back to back per shape; device-only from one
    profiler session over all the sites of a forward or a step) and K2's
    and K2b's bytes bounds.  Returns the kernels line's two rows, from the
    first config, each with host us per call; the other config's totals go
    to the log."""
    from anoddpm_torch.ops import group_norm_silu as gn
    gen = torch.Generator(device=DEVICE).manual_seed(24)
    rows = {}
    for config, sites in sites_of.items():
        for n, key in ((BATCH, "K2"), (TRAIN_BATCH, "K2b")):
            timing, plains = {}, {}
            for shape, dtype in {((n,) + s[1:], dt) for s, dt in sites}:
                if key == "K2":
                    x, gamma, beta = k2_inputs(shape, dtype, gen)
                    fn = lambda: gn.group_norm_silu(x, gamma, beta, order="flax")
                    plain = functools.partial(gn._plain_flax, x, gamma, beta,
                                              1e-5)
                    nbytes = 2 * x.numel() * x.element_size()
                else:
                    x, gamma, beta, go, mean, rstd = k2_inputs(
                        shape, dtype, gen, backward=True)
                    fn = lambda: gn.group_norm_silu_backward(
                        x, go, gamma, beta, mean, rstd, order="flax")
                    plain = functools.partial(gn._plain_flax_backward, x, go,
                                              gamma, beta, False, 1e-5)
                    nbytes = (3 * x.numel() * x.element_size() + 4 * shape[1] * 4
                              + 2 * n * 32 * 4)
                plains[(shape, dtype)] = plain
                timing[(shape, dtype)] = (
                    cuda_ms(fn, 10), graph_ms(fn, reps=10), cuda_ms(plain, 3),
                    nbytes / HBM_BYTES_PER_S * 1e3)
            keys = [((n,) + s[1:], dt) for s, dt in sites]
            plain_dev = profiled_device_ms(
                lambda: [plains[k]() for k in keys], reps=1)
            k, b, p, bound = (sum(timing[s][i] for s in keys) for i in range(4))
            rows[(config, key)] = (k, b, p, plain_dev, bound)
            log(f"{key} in the flax order at args{config}'s {len(sites)} sites, "
                f"N={n} (per {'forward' if key == 'K2' else 'train step'}): "
                f"kernel {k:.3f} ms back to back, {b:.3f} ms device-only; plain "
                f"composition {p:.3f} ms back to back, {plain_dev:.3f} ms "
                f"device-only; bound {bound:.3f} ms ({bound / b:.1%} of it "
                f"device-only)")
    x = torch.randn(K2_HOST_SHAPE, device=DEVICE).to(torch.bfloat16)
    gamma = torch.ones(K2_HOST_SHAPE[1], device=DEVICE)
    beta = torch.zeros(K2_HOST_SHAPE[1], device=DEVICE)
    host = host_us(lambda: gn.group_norm_silu(x, gamma, beta, order="flax"))
    xb = torch.randn(K2B_HOST_SHAPE, device=DEVICE).to(torch.bfloat16)
    gb, bb = gamma.new_ones(K2B_HOST_SHAPE[1]), beta.new_zeros(K2B_HOST_SHAPE[1])
    _, mean, rstd = gn.group_norm_silu_with_stats(xb, gb, bb, order="flax")
    host_b = host_us(lambda: gn.group_norm_silu_backward(
        xb, xb, gb, bb, mean, rstd, order="flax"))
    log(f"flax order host us per call: K2 {host:.2f} at {K2_HOST_SHAPE} bf16, "
        f"K2b {host_b:.2f} at {K2B_HOST_SHAPE} bf16")
    first = next(iter(sites_of))
    note = ("no TPU kernel: the JAX package's default GroupNorm32 + nn.silu "
            "(XLA's fusion); a mode of the kernel in the same source. "
            "library_ms is the plain composition's own device-only time")
    out = []
    for key, name, src, host_call in (
            ("K2", "group_norm_silu (flax order)", "group_norm_silu.cu", host),
            ("K2b", "group_norm_silu_backward (flax order)",
             "group_norm_silu_backward.cu", host_b)):
        t = rows[(first, key)]
        out.append(dict(name=name, route="cuda",
                        source=f"anoddpm_torch/csrc/{src}",
                        replaces="anoddpm_tpu/models/unet.py:48", note=note,
                        max_abs_err=None, ms=t[0], device_ms=t[1],
                        host_us_per_call=host_call, plain_ms=t[2],
                        bound_ms=t[4], bound_by="bytes", library_ms=t[3],
                        library_device_ms=t[3]))
    return out


def norm_path_times(args, card):
    """ms per forward (batch 4, inference) and per train step (batch 8:
    simplex noise, AdamW, EMA) of `args`' UNet under each norm path."""
    from anoddpm_torch import training
    from anoddpm_torch.ops.noise import sampler_from_args
    from anoddpm_torch.schedule import schedule_from_args
    sched = schedule_from_args(args).to(DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(23)
    size = (1, MEASURE_IMG, MEASURE_IMG)
    x4 = torch.randn((BATCH,) + size, generator=gen, device=DEVICE)
    t4 = torch.full((BATCH,), 100, dtype=torch.int64, device=DEVICE)
    x8 = torch.rand((TRAIN_BATCH,) + size, generator=gen, device=DEVICE) * 2 - 1
    times = {}
    for tag, norm in NORM_PATHS.items():
        model = seeded_model({**args, **norm})
        with torch.inference_mode():
            fwd = cuda_ms(lambda: model(x4, t4), MEASURE_TIMING_REPS)
        state = training.init_train_state(model.train(False), training.make_optimizer(
            model.parameters(), 1e-4))
        step = training.make_train_step(sched, sampler_from_args(args), max_t=800)
        train_ms = cuda_ms(lambda: step(state, x8, gen), MEASURE_TIMING_REPS)
        times[tag] = (fwd, train_ms)
        del model, state
        torch.cuda.empty_cache()
    log(f"norm paths at args{S2D64_CONFIG} ({card}): " + "; ".join(
        f"{tag} {f:.3f} ms per forward (batch {BATCH}), {t:.3f} ms per train "
        f"step (batch {TRAIN_BATCH})" for tag, (f, t) in times.items()))
    return times


def measuring_path(card):
    """The measuring entry points at quick sizes on the card, with exact
    launches counted from the models: bench.py's headline (DDIM-15 on the
    s2d64 UNet) and paper DDPM chain at lambda 50, three train steps of the
    paper config through `bench.train_probe` (its FLOP count's step, the
    warm-up and one timed step), the FLOP count on the card against the
    meta device's; `norm_impl="flax"` at args256syn128's and s2d64's widths
    forward and backward (no K2 without pallas_norm, K2 and K2b exactly at
    the eligible sites with it), the flax-order site on the card against
    the CPU at every (C, H, W, dtype) of both models' sites (K2 and K2b in
    their flax order, both bf16_path), their times, ms per forward and
    train step of the three norm paths; and the substep probe cut to 1
    epoch of 8 iterations.  Returns the launches and the kernels line's
    rows of the flax order."""
    from anoddpm_torch import bench
    from anoddpm_torch.campaigns import substep_probe
    from anoddpm_torch.config import load_args
    from anoddpm_torch.ops import group_norm_silu as gn
    from anoddpm_torch.ops.group_norm_silu import BACKWARD_LAUNCHES
    t_phase = time.time()
    total = [0] * 5
    img = MEASURE_IMG
    k = site_count(img_size=img, base_channels=64, space_to_depth=2,
                   attention_resolutions="16,8", n_heads=2)
    k_paper = site_count(img_size=img, base_channels=128,
                         attention_resolutions="16,8", n_heads=2)
    chains = 1 + MEASURE_REPEATS
    sps, spread = counted_launches(
        "bench headline", lambda: bench.run_bench(
            MEASURE_BATCH, t_distance=MEASURE_LAMBDA, img=img,
            base_channels=64, space_to_depth=2, ddim_steps=15, ddim_eta=1.0,
            repeats=MEASURE_REPEATS, device=DEVICE),
        own_order(16 * chains, 15 * k * chains, 0), total)
    paper_sps, _ = counted_launches(
        "bench paper DDPM", lambda: bench.run_bench(
            MEASURE_BATCH, t_distance=MEASURE_LAMBDA, img=img,
            base_channels=128, repeats=MEASURE_REPEATS, device=DEVICE),
        own_order((MEASURE_LAMBDA + 1) * chains, k_paper * MEASURE_LAMBDA * chains,
                  0), total)
    probe = counted_launches(
        "bench train", lambda: bench.train_probe(
            TRAIN_BATCH, img, 128, substeps=1, repeats=1, device=DEVICE),
        own_order(3, 3 * k_paper, 3 * k_paper * BACKWARD_LAUNCHES), total)
    log(f"bench at quick sizes ({card}): headline DDIM-15 at lambda "
        f"{MEASURE_LAMBDA}, batch {MEASURE_BATCH}: {sps:.3f} slices/s (IQR "
        f"{spread['sps_iqr'][0]:.3f}-{spread['sps_iqr'][1]:.3f}), {k} K2 "
        f"sites; paper DDPM-{MEASURE_LAMBDA}: {paper_sps:.3f} slices/s; train "
        f"step at batch {TRAIN_BATCH}: {probe['ms_per_step']:.3f} ms, "
        f"{probe['tflop_per_step']:.4f} TFLOP, MFU {probe['mfu']:.4f} of "
        f"{bench.PEAK_TFLOPS_BF16} TFLOPS (one timed step)")
    flops = counted_launches(
        "FLOP count", lambda: bench.unet_fwd_flops(2, 64, 2, img, device=DEVICE),
        own_order(0, k, 0), total)
    want_flops = bench.unet_fwd_flops(2, 64, 2, img, norm=dict(norm_impl="flax"),
                                      device="meta")
    require(flops == want_flops, f"FLOPs on the card {flops} != {want_flops}")
    log(f"UNet forward FLOPs, headline at batch 2: {flops / 1e9:.3f} GFLOP on "
        f"the card (kernel path), equal to the meta device's count")
    # the JAX package's composition, forward and backward, at both widths:
    # K2 and K2b in their flax order at every site, or, with pallas_norm, K2
    # and K2b in their own order exactly at the sites whose NHWC shape
    # passes the TPU kernel's gate and the flax order at the rest
    sites_of = {}
    for config in (CONFIG, S2D64_CONFIG):
        args = load_args(config, config_dir=os.path.join(ROOT, "configs"))
        sites_of[config] = k2_sites(seeded_model(args), 1, img)
        eligible = sum(gn.eligible((n, h, w, c), dtype)
                       for (n, c, h, w), dtype in sites_of[config])
        require(eligible > 0, f"args{config}: no site passes the gate")
        n_sites = len(sites_of[config])
        for pallas in (False, True):
            model = seeded_model({**args, "norm_impl": "flax",
                                  "bf16_norm": True, "pallas_norm": pallas})
            e = eligible if pallas else 0
            f = n_sites - e
            for batch, grad in ((BATCH, False), (TRAIN_BATCH, True)):
                counted_launches(
                    f"flax args{config} pallas_norm={pallas} batch {batch}",
                    lambda: flax_pass(model, batch, grad),
                    (0, e, e * BACKWARD_LAUNCHES * grad, f,
                     f * BACKWARD_LAUNCHES * grad), total)
            del model
            torch.cuda.empty_cache()
        log(f"flax path, args{config}, bf16_norm: forward at batch {BATCH}, "
            f"forward and backward at {TRAIN_BATCH}: without pallas_norm K2 "
            f"and K2b in the flax order at all {n_sites} sites; with it K2 "
            f"(and K2b) in their own order at {eligible} sites, the flax order "
            f"at the rest")
    gen = torch.Generator(device=DEVICE).manual_seed(22)
    worst = [0.0, 1.0, 0.0, 1.0]
    shapes = sorted({s for sites in sites_of.values() for s in sites}, key=str)
    for shape, dtype in shapes:
        for bf16_path in (False, True):
            got = flax_site_case(shape, dtype, bf16_path, gen)
            worst = [max(worst[0], got[0]), min(worst[1], got[1]),
                     max(worst[2], got[2]), min(worst[3], got[3])]
    log(f"flax order on the card vs the plain composition on the CPU at "
        f"{len(shapes)} (shape, dtype) of both models at N = 1, bf16_path "
        f"off and on, forward and backward: output max|d| {worst[0]:.3e}, "
        f"bit-equal in >= {worst[1]:.4f} of elements; dx max|d| "
        f"{worst[2]:.3e} of its largest magnitude, bit-equal in >= "
        f"{worst[3]:.4f}; bit-identical backward reruns")
    flax_table_check()
    flax_rows = flax_order_times(sites_of)
    for row in flax_rows:
        row["max_abs_err"] = worst[0] if "backward" not in row["name"] \
            else worst[2]
    s2d_args = load_args(S2D64_CONFIG, config_dir=os.path.join(ROOT, "configs"))
    norm_path_times(s2d_args, card)
    # the substep probe, cut
    args = load_args(CONFIG, config_dir=os.path.join(ROOT, "configs"))
    t_cut = SUBSTEP_CUTS["T"]
    steps = 2 * 8                      # epochs 0 and 1, 8 iterations each
    per_run = own_order(steps, k_paper * (steps + t_cut),
                        k_paper * BACKWARD_LAUNCHES * steps)
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build"),
                                     prefix="substeps-") as root:
        os.makedirs(os.path.join(root, "configs"))
        with open(os.path.join(root, "configs", f"args{CONFIG}.json"), "w") as f:
            json.dump({**args, **SUBSTEP_CUTS}, f)
        rows = counted_launches(
            "substep probe", lambda: substep_probe.run(
                SUBSTEP_SETTINGS, root, DEVICE, epochs=1, reps=1,
                iters_per_epoch=8),
            [len(SUBSTEP_SETTINGS) * c for c in per_run], total)
    log(f"substep probe (args{CONFIG}, T {t_cut}, 1 epoch + epoch 0 of 8 "
        f"iterations, {card}): " + "; ".join(
            f"{r['substeps']} substeps {r['sec_per_epoch']:.2f} s per epoch"
            for r in rows))
    log(f"measuring: the phase {time.time() - t_phase:.1f} s; launches "
        f"K1 {total[0]}, K2 {total[1]}, K2b {total[2]}, K2 in the flax order "
        f"{total[3]}, K2b in the flax order {total[4]}")
    return tuple(total), flax_rows


JAX_STREAMS_CONFIG = "256syn64s2d"
JAX_STREAMS_LOG_LOSS = 0.15949   # seed 0's epoch-0 loss, results/seed_replication.log:90
JAX_STREAMS_NORMAL_ULPS = 256    # card's erfinv vs the host's, at the normals' values
JAX_STREAMS_TURNS = 3            # timed rounds per stream, in turns
JAX_STREAMS_STEPS = 5            # train steps per timed round


def jax_train_draws(seed, iters, substeps, batch, max_t):
    """The keys and draws of the JAX trainer's first `iters` steps, built
    from its code (`anoddpm_tpu/train.py:54-58,126`, `training.py:84-85,
    132-140`), as the reference the port's trainer is held to: the loop
    key split(key(seed))[0], passed to every dispatch; one split per
    substep; fold_in(step) split in three; t = randint(t_key) and the
    simplex seeds bits(noise_key), here on the host.  Returns [(t_key,
    noise_key, t, seeds)] per step."""
    from anoddpm_torch.compat import jax_random as jr
    loop_key, out = jr.key(seed).split()[0], []
    for step in range(iters):
        k = loop_key
        for _ in range(step % substeps + 1):
            k, sub = k.split()
        t_key, noise_key, _ = sub.fold_in(step).split(3)
        out.append((t_key, noise_key, jr.randint(t_key, (batch,), 0, max_t),
                    jr.bits(noise_key, (batch,))))
    return out


JAX_SUITE_T = 100       # the suite's schedule: methods A and B at lambda 50
JAX_SUITE_LAMBDA = 10   # the figures' and the validation's small lambda


class KeyRecorder:
    """Records, while on, every draw a JaxKey's view makes (`streams.
    _JaxView`): (method, the key's words, its arguments, its output), the
    output read after the run (reading it in the run would synchronise)."""
    METHODS = ("seeds", "normal", "randint", "bernoulli", "choice",
               "permutation")

    def __init__(self):
        from anoddpm_torch import streams
        self.view = streams._JaxView
        self.real = {m: getattr(self.view, m) for m in self.METHODS}
        self.on, self.draws = False, []
        for m, fn in self.real.items():
            setattr(self.view, m, self._wrap(m, fn))

    def _wrap(self, method, fn):
        def wrapper(view, *a):
            out = fn(view, *a)
            if self.on:
                self.draws.append((method, view.key.words, a, out))
            return out
        return wrapper

    def take(self):
        draws, self.draws = self.draws, []
        return draws

    def close(self):
        for m, fn in self.real.items():
            setattr(self.view, m, fn)


def jax_noise_keys(kind, key):
    """(method, key words) of one sampler call of `kind` on `key`, as the
    JAX package's sampler keys it: randParam splits off its table row's key
    and its seeds' key (`anoddpm_tpu/ops/noise.py:143-145`)."""
    if kind == "simplex_randParam":
        kp, ks = key.split()
        return [("randint", kp.words), ("seeds", ks.words)]
    return [("normal" if kind == "gauss" else "seeds", key.words)]


def jax_chain_keys(key, steps, kind):
    """A chain of `steps` draws, each step splitting one key off."""
    out = []
    for _ in range(steps):
        key, sub = key.split()
        out += jax_noise_keys(kind, sub)
    return out


def jax_fb_keys(key, steps, fwd="simplex", rev="simplex", gradual=False):
    """`forward_backward` on `key` at lambda = steps (`anoddpm_tpu/
    diffusion.py:200-212`): the q-jump's key (or the gradual chain's),
    then the reverse chain's."""
    key_fwd, key_rev = key.split()
    out = (jax_chain_keys(key_fwd, steps, fwd) if gradual
           else jax_noise_keys(fwd, key_fwd))
    return out + jax_chain_keys(key_rev, steps, rev)


def jax_chains(key, n, steps, **kw):
    """n `forward_backward` chains, each on a key split off `key` (methods
    A and B, the ROC, graph_data's chunks)."""
    out = []
    for _ in range(n):
        key, sub = key.split()
        out += jax_fb_keys(sub, steps, **kw)
    return key, out


def hold_draws(what, draws, want):
    """The draws' keys equal `want`, the JAX schedule made on the host, and
    each draw made on the card equals the same draw made on the host from
    its key: t, table rows, coins, seeds, permutations, t by choice bit for
    bit, and the smallest of the dropout masks.  Normals and the other
    masks are held by their keys (threefry's words on the card against
    the host's at full size in `jax_streams_path`)."""
    from anoddpm_torch import streams
    from anoddpm_torch.compat import jax_random as jr
    got = [(m, k) for m, k, _, _ in draws]
    require(got == want, f"{what}: {len(got)} draws, keys "
            f"{'equal' if got[:len(want)] == want[:len(got)] else 'differ'} "
            f"from the JAX schedule's {len(want)}")
    masks = [d for d in draws if d[0] == "bernoulli" and len(d[2][1]) == 4]
    small = {min(masks, key=lambda d: d[3].numel())[1]} if masks else set()
    for m, k, a, out in draws:
        if m == "normal" or (m == "bernoulli" and len(a[1]) == 4
                             and k not in small):
            continue
        host = getattr(streams._JaxView(jr.JaxKey(k)), m)(*a)
        require(torch.equal(out.cpu(), host),
                f"{what}: a {m} draw differs from the host's")


def jax_suite_path(card, args, state, sched, k2):
    """Phase 18's suite: s2d64 at full width under `rng: "jax"` through the
    entry points a user calls, each held to the JAX package's key schedule
    (`hold_draws`) with exact K1 and flax-order K2 launches: one
    `graph_data` chunk (lambda 25..100), methods A and B and A_fixedT at
    lambda 50 (T = JAX_SUITE_T), one `anomalous_validation` slice, one
    `roc_data` volume with the context encoder trained 4 steps, every
    figure once at a small lambda, the noise kinds' draws, and two train
    steps with dropout .1, loss_weight prop-t and simplex_randParam under
    sync-debug "error"."""
    recorder = KeyRecorder()
    try:
        return _jax_suite(card, args, state, sched, k2, recorder)
    finally:
        recorder.close()


def _jax_suite(card, args, state, sched, k2, recorder):
    from anoddpm_torch import baselines, checkpoint, detect, figures
    from anoddpm_torch.compat import jax_random as jr
    from anoddpm_torch.config import KNOWN_KEYS, defaultdict_from_json
    from anoddpm_torch.models.unet import ResBlock
    from anoddpm_torch.ops.noise import make_noise_sampler
    from anoddpm_torch.schedule import schedule_from_args
    from anoddpm_torch.train import dispatch_of, loop_stream
    t0, total = time.time(), [0] * 5
    em = state.ema.eval()
    sargs = defaultdict_from_json({**args, "T": JAX_SUITE_T, "sample_distance":
                                   2 * JAX_SUITE_LAMBDA, "noise_fn": "simplex"})
    ssched = schedule_from_args(sargs).to(DEVICE)
    key = jr.key
    lam = JAX_SUITE_LAMBDA

    def run(what, fn, k1, forwards, want, backwards=0, sync=False):
        """fn() with exactly k1 K1 launches and the flax-order K2 (K2b) of
        `forwards` (`backwards`) UNet passes, its draws held to `want`;
        under sync-debug "error" with `sync`."""
        recorder.take()
        recorder.on = True
        try:
            with sync_debug_error() if sync else contextlib.nullcontext():
                out = counted_launches(
                    f"JAX suite: {what}", fn,
                    (k1, 0, 0, k2 * forwards, 2 * k2 * backwards), total)
        finally:
            recorder.on = False
        hold_draws(f"JAX suite: {what}", recorder.take(), want)
        return out

    x_np, m_np = figures._first_slice(sargs, ROOT)
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build"),
                                     prefix="jax-suite-") as root:
        triple = (sargs, em, ssched)
        run("one graph chunk (lambda 25..100)",
            lambda: detect.graph_data(triple, root_dir=root, lambdas=[25, 50, 75, 100],
                                      max_volumes=1, lambda_batch=4, device=DEVICE),
            101, 100, jax_chains(key(11), 1, 100)[1])
        run("method A (7 frequencies, lambda 50)",
            lambda: detect.detection_A(sargs, em, ssched, x_np, m_np, "s",
                                       root_dir=root, total_avg=1),
            7, 7 * 50, jax_chains(key(2), 7, 50, rev="gauss")[1])
        run("method B (octave, lambda 50)",
            lambda: detect.detection_B(sargs, em, ssched, x_np, m_np, "s",
                                       root_dir=root, total_avg=1),
            1, 50, jax_chains(key(3), 1, 50, rev="gauss")[1])
        _, kf, kr = key(4).split(3)
        run("method A at fixed lambda 50",
            lambda: detect.detection_A_fixedT(sargs, em, ssched, x_np, m_np,
                                              end_freq=1, t_distance=50),
            51, 50, [("seeds", kf.words)] + jax_chain_keys(kr, 50, "simplex"))
        _, k_t, k1, k2_, _ = key(5).split(5)
        t = 2 + int(jr.randint(k_t, (), 0, 10))
        run(f"one validation slice (t {t})",
            lambda: detect.anomalous_validation(triple, root_dir=root,
                                                max_volumes=1, max_slices=1,
                                                detection_avg=1, device=DEVICE),
            2 * t + 1, t + 50,
            [("randint", k_t.words)] + jax_fb_keys(k1, t, gradual=True)
            + jax_chains(k2_, 1, 50, rev="gauss")[1])
        sd = em.state_dict()
        for token, kind in (("jsuite", "simplex"), ("jsuiteg", "gauss")):
            checkpoint.save_checkpoint(root, {**sargs, "arg_num": token,
                                              "noise_fn": kind}, 0, sd, sd, {},
                                       final=True)
        os.makedirs(os.path.join(root, "configs"), exist_ok=True)
        with open(os.path.join(root, "configs", "argsjsuite.json"), "w") as f:
            json.dump({k: v for k, v in sargs.items()
                       if k in KNOWN_KEYS and k != "arg_num"}, f)
        ce_key, ce_keys = key(1), []
        for _ in range(4):
            ce_key, sub = ce_key.split()
            ce_keys += [("randint", k.words) for k in sub.split()]
        t_roc = time.time()
        curves = run("the 3-way ROC's shape: one volume (lambda 20) of the "
                     "simplex and the Gaussian model, the context encoder's 4 "
                     "steps, diffuse lesions at severity 1.5",
                     lambda: detect.roc_data(["jsuite", "jsuiteg"], root_dir=root,
                                             t_distance=20, max_volumes=1,
                                             ce_token="jsuite", ce_train_steps=4,
                                             args_override={"lesion_kind": "diffuse",
                                                            "lesion_severity": 1.5},
                                             device=DEVICE),
                     21, 40, jax_chains(key(13), 1, 20)[1]
                     + jax_chains(key(13), 1, 20, fwd="gauss", rev="gauss")[1]
                     + ce_keys)
        require(set(curves) == {"argsjsuite", "argsjsuiteg", "context-encoder"},
                f"JAX suite: ROC curves {sorted(curves)}")
        print(f"JAX suite: the 3-way ROC {time.time() - t_roc:.1f} s", flush=True)
        fargs, fem, fsched = figures._load_eval_model(root, "jsuite", device=DEVICE)
        whole = lambda seed, kind="simplex": jax_fb_keys(key(seed), lam, kind,
                                                         kind, gradual=True)
        half = lambda seed, kind="simplex": jax_fb_keys(key(seed), lam, kind, kind)
        _, kf, kr = key(4).split(3)
        for name, fn, k1, forwards, want in (
                ("ano", lambda: figures.ano_outputs(
                    fargs, fem, fsched, root_dir=root, n_attempts=1,
                    t_distance=lam), 2 * lam, lam, whole(0)),
                ("sequence", lambda: figures.denoise_sequence(
                    fargs, fem, fsched, root_dir=root), 2 * lam, lam, whole(0)),
                ("masked_comparison", lambda: figures.masked_comparison(
                    fargs, fem, fsched, root_dir=root, t_distance=lam,
                    n_volumes=1), lam + 1, lam, half(0)),
                ("videos", lambda: figures.diffusion_videos(
                    fargs, fem, fsched, root_dir=root, n_volumes=1),
                 2 * lam, lam, whole(0)),
                ("gauss_simplex", lambda: figures.gauss_simplex_comparison(
                    fargs, fem, fsched, root_dir=root, t_distance=lam),
                 lam + 1, 2 * lam, half(7, "gauss") + half(7)),
                ("varying_frequency", lambda: figures.varying_frequency(
                    fargs, fem, fsched, root_dir=root, end_freq=1),
                 JAX_SUITE_T + 1, JAX_SUITE_T,
                 [("seeds", kf.words)] + jax_chain_keys(kr, JAX_SUITE_T, "simplex")),
                ("varying_t", lambda: figures.gauss_varying_t(
                    fargs, fem, fsched, root_dir=root, lambdas=(lam,)),
                 0, lam, half(lam, "gauss")),
                ("test_set", lambda: figures.test_set_outputs(
                    "jsuite", "jsuiteg", root_dir=root, anomalous=True,
                    t_distance=lam, n_attempts=1, device=DEVICE),
                 2 * lam, 2 * lam, whole(0) + whole(0, "gauss"))):
            run(f"figure {name}", fn, k1, forwards, want)
        del fem
        ce = baselines.train_context_encoder(fargs, root_dir=root, steps=4,
                                             device=DEVICE)
        run("figure ce", lambda: figures.ce_outputs(fargs, ce, root_dir=root,
                                                    n_attempts=1, rows=1),
            0, 0, [])
        got = {p for p in files_under(root) if p.startswith("final-outputs")}
        require(len(got) >= 9, f"JAX suite: figures wrote {sorted(got)}")

    # the noise kinds' own draws on the card: randParam's row and seeds,
    # random's coin, the table path's permutations, simplex_2d's seeds
    shape, tt = (2, 1, 256, 256), torch.full((2,), 7, device=DEVICE)
    for seed, (kind, kw, k1, want) in enumerate((
            ("simplex_randParam", {}, 1,
             lambda k: jax_noise_keys("simplex_randParam", k)),
            ("random", {}, 1, lambda k: [("bernoulli", k.split()[0].words),
                                         ("normal", k.split()[1].words),
                                         ("seeds", k.split()[1].words)]),
            ("simplex", {"table": True}, 0, lambda k: [("permutation", k.words)]),
            ("simplex_2d", {}, 0, lambda k: [("seeds", k.words)]))):
        sampler = make_noise_sampler(kind, **kw)
        field = run(f"noise {kind}{' (table)' if kw else ''}",
                    lambda: sampler(shape, tt, key(30 + seed, DEVICE)), k1, 0,
                    want(key(30 + seed)))
        require(bool(torch.isfinite(field).all()), f"JAX suite: {kind} field")

    # two train steps, dropout .1, prop-t, simplex_randParam, 2 substeps
    dargs = defaultdict_from_json({**args, "dropout": 0.1, "loss_weight": "prop-t",
                                   "noise_fn": "simplex_randParam",
                                   "train_substeps": 2})
    # the model's ResBlocks at the rate a dropout config builds them with
    blocks = [m for m in state.model.modules() if isinstance(m, ResBlock)]
    for m in blocks:
        m.dropout = 0.1
    step, _ = dispatch_of(dargs, sched, make_noise_sampler("simplex_randParam"))
    x = torch.randn((2, int(args["Batch_Size"]), 1, 256, 256),
                    generator=torch.Generator(device=DEVICE).manual_seed(41),
                    device=DEVICE)
    k, want = loop_stream(dargs, "cpu"), []
    for s in range(2):
        k, sub = k.split()
        t_key, noise_key, drop_key = sub.fold_in(state.step + s).split(3)
        want += [("choice", t_key.words)] + jax_noise_keys("simplex_randParam",
                                                           noise_key)
        want += [("bernoulli", jr.fold_in_static(drop_key, (name, "Dropout_0", 1)).words)
                 for name in state.model._plan
                 if isinstance(getattr(state.model, name, None), ResBlock)]
    loss = run("two train steps (dropout .1, prop-t, simplex_randParam)",
               lambda: step(state, x, loop_stream(dargs, DEVICE))["loss"],
               2, 2, want, backwards=2, sync=True)
    require(math.isfinite(float(loss)), f"JAX suite: train loss {float(loss)}")
    for m in blocks:
        m.dropout = 0.0
    log(f"JAX suite (s2d64, rng jax): graph chunk, methods A, B, A_fixedT, "
        f"validation, ROC + CE, 9 figures, noise kinds, 2 dropout/prop-t/"
        f"randParam train steps: every draw's key the JAX schedule's, the "
        f"card's draws the host's; launches {total}; {time.time() - t0:.1f} s "
        f"({card})")
    return total


def jax_streams_path(card):
    """Phase 18: the port on the JAX package's streams at s2d64's full
    width (flax order, the band recipe's 8 substeps), through its own entry
    points: the trainer's dispatch (`train.dispatch_of`) on its loop stream
    (`train.loop_stream`) for epoch 0, and `detect.anomalous_metric_
    calculation` on one volume group at DDIM-20 eta 1, each under
    sync-debug with exact launches and with the keys and draws it made held
    to the JAX trainer's and detector's schedules (`jax_train_draws`,
    `jax_fb_keys`, `hold_draws`); then the suite (`jax_suite_path`), and
    the same at args256syn128's full width (`jax_paper_path`)."""
    from anoddpm_torch import detect, diffusion
    from anoddpm_torch.campaigns.seed_replication import (PROTOCOLS,
                                                          train_args_for)
    from anoddpm_torch.compat import jax_random as jr
    from anoddpm_torch.data.datasets import dataset_from_args
    from anoddpm_torch.data.pipeline import batch_iterator, prefetch_to_device
    from anoddpm_torch.models.unet import NormSiLU
    from anoddpm_torch.ops.noise import sampler_from_args
    from anoddpm_torch.schedule import schedule_from_args
    from anoddpm_torch.train import dispatch_of, loop_stream, new_train_state
    args = train_args_for(JAX_STREAMS_CONFIG, 0, ROOT, "jax_rng")
    b, substeps = int(args["Batch_Size"]), int(args["train_substeps"])
    iters, seed = int(args["iters_per_epoch"]), int(args["seed"])
    sched = schedule_from_args(args).to(DEVICE)
    sampler = sampler_from_args(args)
    step, max_t = dispatch_of(args, sched, sampler)
    want = jax_train_draws(seed, iters, substeps, b, max_t)
    # jax_random's torch path (a draw made on the card) against its numpy
    # path on the host, at the train steps' keys and a VLB-sized normal
    for t_key, noise_key, t, seeds in want:
        require(torch.equal(jr.randint(t_key.on(DEVICE), (b,), 0, max_t).cpu(), t)
                and torch.equal(jr.bits(noise_key.on(DEVICE), (b,)).cpu(), seeds),
                "JAX streams: a train step's t or seeds differ on the card")
    shape = (b, 256, 256, 1)
    big = jr.key(2).split()[1]
    got = jr.normal(big.on(DEVICE), shape).cpu()
    require(torch.equal(jr.bits(big.on(DEVICE), shape).cpu(), jr.bits(big, shape)),
            "JAX streams: the VLB's words differ on the card")
    worst_ulps = int((got.view(torch.int32).long()
                      - jr.normal(big, shape).view(torch.int32).long()).abs().max())
    require(worst_ulps <= JAX_STREAMS_NORMAL_ULPS,
            f"JAX streams: normals {worst_ulps} ulps from the host's")

    # epoch 0 of seed 0: the JAX init, the band recipe's batches, the
    # trainer's dispatch on its loop stream
    warm = new_train_state(args, torch.device(DEVICE))
    loader = prefetch_to_device(batch_iterator(
        dataset_from_args(ROOT, args, train=True), b, shuffle=True), DEVICE,
        substeps=substeps)
    try:
        batches = [next(loader)["image"] for _ in range(iters // substeps)]
    finally:
        loader.close()
    dispatch_of(args, sched, sampler)[0](warm, batches[0],
                                         loop_stream(args, DEVICE))   # lazy set-up
    del warm
    state = new_train_state(args, torch.device(DEVICE))
    k2 = sum(isinstance(m, NormSiLU) for m in state.model.modules())
    require(k2 == 71, f"JAX streams: {k2} norm+SiLU sites, s2d64 has 71")
    total = [0] * 5
    losses = []
    recorder = KeyRecorder()
    try:
        recorder.on = True
        with sync_debug_error():
            for x in batches:
                losses.append(counted_launches(
                    "JAX streams: a dispatch of 8 steps",
                    lambda x=x: step(state, x, loop_stream(args, DEVICE))["loss"],
                    (substeps, 0, 0, k2 * substeps, 2 * k2 * substeps), total))
        recorder.on = False
        hold_draws("JAX streams: the trainer's t and seeds", recorder.take(),
                   [d for t_key, noise_key, _, _ in want
                    for d in (("randint", t_key.words), ("seeds", noise_key.words))])
        loss = float(torch.stack(losses).mean())
        require(math.isfinite(loss), f"JAX streams: epoch-0 loss {loss}")
        log(f"JAX streams: the trainer's {iters} steps drew the JAX trainer's "
            f"t and seeds; card draws bit-equal to the host's; normals at "
            f"{shape} within {worst_ulps} ulps of the host's (erfinv)")
        log(f"JAX streams: seed 0 epoch-0 loss {loss:.5f} beside the JAX "
            f"package's TPU log {JAX_STREAMS_LOG_LOSS} "
            f"({100 * (loss / JAX_STREAMS_LOG_LOSS - 1):+.2f}%, not held; "
            f"{card}); launches {total}, {k2} sites")

        # one volume group of the DDIM-20 eta 1 cell through the detector
        protocol = PROTOCOLS["s2d64_ddim20_eta1"]
        n_steps = int(protocol["ddim_steps"])
        chain, det_total = diffusion.forward_backward_ddim, [0] * 5

        def counted_chain(*a, **k):
            with sync_debug_error():
                return counted_launches(
                    "JAX streams: a DDIM-20 detection group",
                    lambda: chain(*a, **k), (n_steps + 1, 0, 0, k2 * n_steps, 0),
                    det_total)
        diffusion.forward_backward_ddim = counted_chain
        os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
        try:
            with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build"),
                                             prefix="jax-streams-") as root:
                recorder.on = True
                det_args = copy.copy(args)
                det_args.update(protocol)
                summary = detect.anomalous_metric_calculation(
                    args=det_args, root_dir=root,
                    em=state.ema.eval(), sched=sched, max_volumes=1,
                    device=DEVICE)
                recorder.on = False
        finally:
            diffusion.forward_backward_ddim = chain
        drawn = recorder.take()
        n = drawn[0][3].numel() if drawn else 0
        # key(seed + 1) split once for the group (`anoddpm_tpu/detect.py:199,
        # 210`), the group's chain keyed as `forward_backward_ddim` keys it
        hold_draws("JAX streams: the detector's seeds", drawn,
                   jax_fb_keys(jr.key(seed + 1).split()[1], n_steps))
        require(det_total == [n_steps + 1, 0, 0, k2 * n_steps, 0],
                f"JAX streams: detection launches {det_total}")
        require(all(math.isfinite(summary[m]) for m in ("auc", "dice")),
                f"JAX streams: detection summary {summary}")
    finally:
        recorder.close()
    for i, c in enumerate(det_total):
        total[i] += c
    log(f"JAX streams: one DDIM-20 eta 1 group ({n} slices) through the "
        f"detector drew the JAX detector's {len(drawn)} seed sets; "
        f"launches {det_total}; AUC {summary['auc']:.4f}, Dice "
        f"{summary['dice']:.4f}")

    # ms per train step, a JAX key and a torch Generator in turns
    from anoddpm_torch import training
    one = training.make_train_step(sched, sampler, max_t=max_t)
    streams = {"jax": loop_stream(args, DEVICE),
               "torch": torch.Generator(device=DEVICE).manual_seed(0)}
    ms = {name: [] for name in streams}
    for _ in range(JAX_STREAMS_TURNS):
        for name, stream in streams.items():
            torch.cuda.synchronize()
            t0 = time.time()
            for _ in range(JAX_STREAMS_STEPS):
                one(state, batches[0][0], stream)
            torch.cuda.synchronize()
            ms[name].append((time.time() - t0) / JAX_STREAMS_STEPS * 1e3)
    log("JAX streams: ms per train step (s2d64, batch 8, flax order), in "
        "turns: " + "; ".join(f"{n} " + ", ".join(f"{v:.2f}" for v in vals)
                              for n, vals in ms.items()))
    suite = jax_suite_path(card, args, state, sched, k2)
    total = [a + b for a, b in zip(total, suite)]
    del state
    torch.cuda.empty_cache()
    paper = jax_paper_path(card)
    return [a + b for a, b in zip(total, paper)]


JAX_PAPER_CONFIG = "256syn128"
JAX_PAPER_SITES = 85
# seed 0's epoch-0 loss on the TPU (the mean of its 16 steps)
JAX_PAPER_LOG_LOSS = ("results/seed_replication.log:3", 0.12589)


def jax_paper_path(card):
    """Phase 18's paper part: args256syn128 at full width on the JAX
    package's streams in the band recipe (flax order, 8 substeps, batch 8),
    through the s2d64 part's entry points: the first dispatch of seed 0's
    epoch 0 (`train.dispatch_of` on `train.loop_stream`) under sync-debug
    with exact launches, its t and seeds held to `jax_train_draws`; then
    one volume group of `paper128_ddpm200` (DDPM, lambda 200) through
    `detect.anomalous_metric_calculation` under sync-debug, with 201 K1 and
    200 x 85 flax-order K2, its keys held to `jax_fb_keys` and its draws
    by `hold_draws`.  Each wall on a line of its own."""
    from anoddpm_torch import detect, diffusion
    from anoddpm_torch.campaigns.seed_replication import (PROTOCOLS,
                                                          train_args_for)
    from anoddpm_torch.compat import jax_random as jr
    from anoddpm_torch.data.datasets import dataset_from_args
    from anoddpm_torch.data.pipeline import batch_iterator, prefetch_to_device
    from anoddpm_torch.models.unet import NormSiLU
    from anoddpm_torch.ops.noise import sampler_from_args
    from anoddpm_torch.schedule import schedule_from_args
    from anoddpm_torch.train import dispatch_of, loop_stream, new_train_state
    args = train_args_for(JAX_PAPER_CONFIG, 0, ROOT, "jax_rng")
    b, substeps = int(args["Batch_Size"]), int(args["train_substeps"])
    seed = int(args["seed"])
    sched = schedule_from_args(args).to(DEVICE)
    sampler = sampler_from_args(args)
    step, max_t = dispatch_of(args, sched, sampler)
    want = jax_train_draws(seed, substeps, substeps, b, max_t)
    loader = prefetch_to_device(batch_iterator(
        dataset_from_args(ROOT, args, train=True), b, shuffle=True), DEVICE,
        substeps=substeps)
    try:
        x = next(loader)["image"]
    finally:
        loader.close()
    # the lazy set-up at these shapes on a throwaway state (torch's init:
    # flax's, drawn on the host, is the slow part)
    warm = new_train_state({**args, "rng": "torch"}, torch.device(DEVICE))
    dispatch_of(args, sched, sampler)[0](warm, x, loop_stream(args, DEVICE))
    del warm
    torch.cuda.synchronize()
    t0 = time.time()
    state = new_train_state(args, torch.device(DEVICE))
    log(f"JAX streams, paper: flax's init of seed 0 on the host and its copy "
        f"to the card {time.time() - t0:.1f} s")
    k2 = sum(isinstance(m, NormSiLU) for m in state.model.modules())
    require(k2 == JAX_PAPER_SITES, f"JAX streams, paper: {k2} norm+SiLU "
            f"sites, args256syn128 has {JAX_PAPER_SITES}")
    total, det_total = [0] * 5, [0] * 5
    recorder = KeyRecorder()
    try:
        recorder.on = True
        t0 = time.time()
        with sync_debug_error():
            loss = counted_launches(
                "JAX streams, paper: a dispatch of 8 steps",
                lambda: step(state, x, loop_stream(args, DEVICE))["loss"],
                (substeps, 0, 0, k2 * substeps, 2 * k2 * substeps), total)
        loss = float(loss)
        log(f"JAX streams, paper: the first dispatch ({substeps} steps at "
            f"batch {b}) {time.time() - t0:.2f} s")
        recorder.on = False
        hold_draws("JAX streams, paper: the trainer's t and seeds",
                   recorder.take(),
                   [d for t_key, noise_key, _, _ in want
                    for d in (("randint", t_key.words), ("seeds", noise_key.words))])
        require(math.isfinite(loss), f"JAX streams, paper: loss {loss}")
        where, log_loss = JAX_PAPER_LOG_LOSS
        log(f"JAX streams, paper: seed 0's first dispatch drew the JAX "
            f"trainer's t and seeds; its loss (the mean of its {substeps} "
            f"steps) {loss:.5f} beside the TPU log's epoch-0 loss {log_loss} "
            f"({where}, the mean of 16 steps; "
            f"{100 * (loss / log_loss - 1):+.2f}%, not held; {card}); "
            f"launches {total}, {k2} sites")

        # one volume group of the paper's protocol through the detector
        chain = diffusion.forward_backward
        steps = 200

        def counted_chain(*a, **k):
            with sync_debug_error():
                return counted_launches(
                    "JAX streams, paper: a DDPM-200 detection group",
                    lambda: chain(*a, **k), (steps + 1, 0, 0, k2 * steps, 0),
                    det_total)
        diffusion.forward_backward = counted_chain
        os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
        try:
            with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build"),
                                             prefix="jax-paper-") as root:
                recorder.on = True
                det_args = copy.copy(args)
                det_args.update(PROTOCOLS["paper128_ddpm200"])
                t0 = time.time()
                summary = detect.anomalous_metric_calculation(
                    args=det_args, root_dir=root, em=state.ema.eval(),
                    sched=sched, max_volumes=1, device=DEVICE)
                det_s = time.time() - t0
                recorder.on = False
        finally:
            diffusion.forward_backward = chain
        drawn = recorder.take()
        n = drawn[0][3].numel() if drawn else 0
        log(f"JAX streams, paper: one DDPM-200 volume group ({n} slices) "
            f"through the detector {det_s:.2f} s")
        hold_draws("JAX streams, paper: the detector's seeds", drawn,
                   jax_fb_keys(jr.key(seed + 1).split()[1], steps))
        require(det_total == [steps + 1, 0, 0, k2 * steps, 0],
                f"JAX streams, paper: detection launches {det_total}")
        require(all(math.isfinite(summary[m]) for m in ("auc", "dice")),
                f"JAX streams, paper: detection summary {summary}")
    finally:
        recorder.close()
    log(f"JAX streams, paper: the DDPM-200 group drew the JAX detector's "
        f"{len(drawn)} seed sets; launches {det_total}; AUC "
        f"{summary['auc']:.4f}, Dice {summary['dice']:.4f} (one dispatch's "
        f"weights: not a quality figure)")
    del state
    torch.cuda.empty_cache()
    return [a + b for a, b in zip(total, det_total)]


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from anoddpm_torch.config import load_args

    t_start = time.time()
    phases, mark = {}, [t_start]

    def phase(what):
        now = time.time()
        phases[what] = now - mark[0]
        mark[0] = now

    name = device_info()
    build_kernels()
    writers = probe_writers()
    phase("build")
    k1_row = check_k1()
    k1_worst, _ = check_k1_shapes()
    phase("K1 checks")
    k1_worst = max(k1_worst, check_noise_kinds())
    phase("noise kinds")
    args = load_args(CONFIG, config_dir=os.path.join(ROOT, "configs"))
    model = seeded_model(args)
    sites = k2_sites(model)
    k2_row = check_k2(sites)
    k2_worst, _ = check_k2_batches(sites)
    k2b_row = check_k2b(sites)
    check_small_chain()
    check_small_train()
    phase("K2 and K2b checks")
    counts = {"detect": main_path(model, args, len(sites))}
    phase("detection")
    counts["ddim"] = ddim_path(model, args, len(sites))
    phase("DDIM")
    counts["graph"] = graph_path(model, args, len(sites))
    phase("graph")
    from anoddpm_torch.parallel.mesh import close_mesh, init_mesh
    mesh = init_mesh(DEVICE, init_method=f"tcp://localhost:{free_port()}",
                     rank=0, world_size=1)
    # from here on every shape K2 and K2b launch at is held against the
    # plain versions after the path that launched it
    record_launch_shapes()
    shape_worst = [0.0, 0.0]

    def shapes_of(what):
        got = check_launched_shapes(what)
        shape_worst[:] = [max(a, b) for a, b in zip(shape_worst, got)]

    try:
        counts["sharded"] = sharded_path(model, args, len(sites), mesh)
        shapes_of("sharded detection")
        phase("sharded detection")
        del model
        torch.cuda.empty_cache()
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True).stdout.strip()
        with tempfile.TemporaryDirectory() as train_root:
            counts["train"] = train_path(args, len(sites), card, train_root)
            shapes_of("training")
            phase("training")
            counts["roc"] = roc_path(train_root, len(sites))
            shapes_of("ROC with CE")
            phase("ROC with CE")
        counts["ddp"] = ddp_path(args, len(sites), mesh, card)
        shapes_of("DDP (NCCL W = 1, 2 gloo ranks, full width)")
        phase("DDP")
    finally:
        close_mesh(mesh)
    counts["remat"] = remat_path(args, len(sites), card)
    shapes_of("remat")
    phase("remat")
    counts["substeps"] = substeps_path(card)
    shapes_of("substeps")
    phase("substeps")
    counts["ce"] = ce_path(args)
    phase("context encoder")
    counts["small_suite"] = small_suite(writers)
    shapes_of("32^2 suite")
    phase("32^2 suite")
    counts["figures"] = figures_path(writers)
    shapes_of("figures")
    phase("figures")
    native_path()
    phase("native oracle")
    from anoddpm_torch.models.unet import NormSiLU
    counts["texture"] = texture_passes(
        lambda m: sum(isinstance(x, NormSiLU) for x in m.modules()))
    shapes_of("texture passes")
    phase("texture passes")
    mri_counts, _, _, k2b_worst = mri_path(card)
    shapes_of("MRI configuration")
    phase("MRI configuration")
    counts.update(mri_counts)
    counts["campaign"] = campaign_path(len(sites), card)
    shapes_of("campaign")
    phase("campaign")
    counts["s2d64"] = s2d64_path(card)
    shapes_of("s2d64 campaigns")
    phase("s2d64 campaigns")
    counts["measuring"], flax_rows = measuring_path(card)
    shapes_of("measuring")
    phase("measuring")
    counts["jax_streams"] = jax_streams_path(card)
    shapes_of("JAX streams")
    phase("JAX streams")
    k2b_row["max_abs_err"] = max(k2b_row["max_abs_err"], k2b_worst,
                                 shape_worst[1])
    k1_row["max_abs_err"] = max(k1_row["max_abs_err"], k1_worst)
    k2_row["max_abs_err"] = max(k2_row["max_abs_err"], k2_worst, shape_worst[0])
    rows = (k1_row, k2_row, k2b_row, *flax_rows)
    for i, row in enumerate(rows):
        row["launches_by_path"] = {p: c[i] for p, c in counts.items()}
        row["launches"] = sum(row["launches_by_path"].values())
        row.setdefault("library_device_ms", None)
        row.setdefault("note", None)
    log("phases (s): " + ", ".join(f"{k} {v:.1f}" for k, v in phases.items()))
    log(f"total {time.time() - t_start:.1f} s")
    keys = ("name", "route", "source", "replaces", "launches",
            "launches_by_path", "max_abs_err", "ms", "device_ms",
            "host_us_per_call", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "library_device_ms", "note")
    print(json.dumps({"kernels": [{k: row[k] for k in keys} for row in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
