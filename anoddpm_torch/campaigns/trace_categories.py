"""Where a train step's time goes, on the card:

    python -m anoddpm_torch.campaigns.trace_categories trace DIR [STEPS]
    python -m anoddpm_torch.campaigns.trace_categories decompose [BATCH] [BASE] [S2D]

What `scripts/trace_categories.py` and `scripts/train_step_decompose.py`
do for the JAX package, beyond `scripts/torch_train_profile.py`:

- `trace`: the device time of a Chrome trace that `observe.ProfileWindow`
  wrote (ANODDPM_PROFILE_DIR; {DIR}/{name}/trace.json, the newest under
  DIR), every kernel event summed by kind with `kind_of` (the classifier
  `scripts/torch_train_profile.py` uses), and per step when STEPS is given;
- `decompose`: bench.py's UNet at 256^2 (bf16, simplex noise, t < 800):
  the forward loss, forward + backward, the full step (clip, AdamW, EMA)
  and `make_multi_step`'s 8 eager steps per call, each the median of 8
  timed calls after a warm-up, the first two with their FLOPs
  (`bench.count_flops`) and the MFU (`bench.mfu`).
"""

from __future__ import annotations

import glob
import json
import os
import re
import sys
import time
from collections import Counter
from typing import Dict, Optional

import numpy as np
import torch

from .. import diffusion as dm
from ..bench import T_TRAIN_MAX, bench_unet, card_info, count_flops, mfu, sync
from ..device import DeviceLike, resolve_device
from ..ops.noise import make_noise_sampler
from ..schedule import get_beta_schedule, make_schedule
from ..training import (init_train_state, make_multi_step, make_optimizer,
                        make_train_step)

KINDS = [  # first match wins
    ("K1 simplex field", r"octave_field"),
    ("K2b group_norm_silu backward", r"group_norm_silu_bwd"),
    ("K2 group_norm_silu", r"group_norm_silu_kernel"),
    ("conv backward (dgrad, wgrad)", r"dgrad|wgrad"),
    ("conv forward", r"conv|fprop|implicit"),
    ("layout transpose", r"nchwToNhwc|nhwcToNchw|nchw.*nhwc|nhwc.*nchw"),
    ("matmul", r"gemm|cutlass|xmma"),
    ("AdamW (fused)", r"fused_adam|FusedAdam|adam"),
    ("foreach (clip, EMA, grad zeroing)", r"multi_tensor_apply|foreach"),
    ("softmax", r"softmax"),
    ("elementwise", r"elementwise|CatArrayBatched|index"),
    ("reduction", r"reduce"),
]


def kind_of(name: str) -> str:
    for kind, pattern in KINDS:
        if re.search(pattern, name, re.IGNORECASE):
            return kind
    return "other"


def newest_trace(root: str) -> str:
    paths = sorted(glob.glob(os.path.join(root, "**", "trace.json"),
                             recursive=True), key=os.path.getmtime)
    if not paths:
        raise FileNotFoundError(f"no trace.json under {root}")
    return paths[-1]


def summarise(path: str, steps: Optional[int] = None, top: int = 20) -> Dict:
    """Device time by kind (and the `top` costliest kernel names) of a
    Chrome trace; raises when it holds no kernel, as a trace taken without
    a card does."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and e.get("cat") == "kernel"]
    if not events:
        raise ValueError(f"{path}: no device kernel in the trace")
    kinds, names = Counter(), Counter()
    for e in events:
        kinds[kind_of(e["name"])] += e.get("dur", 0)
        names[e["name"]] += e.get("dur", 0)
    total = sum(kinds.values())       # microseconds
    per_step = f" ({total / steps / 1e3:.3f} ms/step)" if steps else ""
    print(f"device kernel total: {total / 1e6:.6f} s{per_step}  [{path}]")
    for kind, dur in kinds.most_common():
        print(f"  {dur / total * 100:5.1f}%  {dur / 1e3:10.3f} ms  {kind}")
    print("costliest kernels:")
    for name, dur in names.most_common(top):
        print(f"  {dur / total * 100:5.1f}%  {dur / 1e3:10.3f} ms  {name[:100]}")
    return {"trace": path, "kernels": len(events), "total_ms": total / 1e3,
            "ms_per_step": total / steps / 1e3 if steps else None,
            "kinds_ms": {k: v / 1e3 for k, v in kinds.items()}}


def timeit(fn, device: torch.device, iters: int = 8):
    """(median, std) seconds of fn() over `iters` calls after a warm-up."""
    fn()
    sync(device)
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        sync(device)
        times.append(time.perf_counter() - t0)
    return float(np.median(times)), float(np.std(times))


def decompose(batch: int = 8, base: int = 128, s2d: int = 1, img: int = 256,
              substeps: int = 8, iters: int = 8, norm: Optional[Dict] = None,
              device: DeviceLike = None) -> Dict:
    device = resolve_device(device)
    model = bench_unet(img, base, s2d, norm, device, perturb=False)
    sched = make_schedule(get_beta_schedule(1000, "linear")).to(device)
    sampler = make_noise_sampler("simplex")
    state = init_train_state(model, make_optimizer(model.parameters(), 1e-4))
    x = torch.from_numpy(np.random.default_rng(0).uniform(
        -1, 1, (batch, 1, img, img)).astype(np.float32)).to(device)
    gen = torch.Generator(device=device).manual_seed(0)

    def loss():
        t = dm.sample_timesteps(gen, batch, T_TRAIN_MAX)
        return dm.calc_loss(model, sched, x, t, gen, sampler, "l2")[0].mean()

    def forward():
        with torch.no_grad():
            return loss()

    def forward_backward():
        model.zero_grad(set_to_none=True)
        loss().backward()

    step = make_train_step(sched, sampler, max_t=T_TRAIN_MAX)
    multi = make_multi_step(step, substeps)
    xs = x.expand((substeps,) + tuple(x.shape)).contiguous()
    step_flops = count_flops(forward_backward)
    ms, sd = timeit(lambda: multi(state, xs, gen), device, max(iters // 2, 1))
    rows = {"forward loss": (timeit(forward, device, iters), count_flops(forward)),
            "forward + backward": (timeit(forward_backward, device, iters),
                                   step_flops),
            "full step (+clip, AdamW, EMA)": (
                timeit(lambda: step(state, x, gen), device, iters), step_flops),
            f"{substeps} steps per call, per step": ((ms / substeps, sd / substeps),
                                                     step_flops)}
    print(f"config: {img}^2 base-{base} s2d-{s2d} batch {batch} bf16, "
          f"norm {norm or 'kernel'}; {card_info(device)}")
    out = {}
    for tag, ((sec, sd), flops) in rows.items():
        share = mfu(flops, sec, device)
        print(f"{tag:34s} {sec * 1e3:9.3f} ms (sd {sd * 1e3:7.3f})  "
              f"{flops / 1e12:7.3f} TFLOP  MFU "
              + ("not measured (no card)" if share is None
                 else f"{share * 100:5.2f}%"), flush=True)
        out[tag] = {"ms": sec * 1e3, "sd_ms": sd * 1e3, "tflop": flops / 1e12,
                    "mfu": share}
    fwd, vg = out["forward loss"]["ms"], out["forward + backward"]["ms"]
    full = out["full step (+clip, AdamW, EMA)"]["ms"]
    fused = out[f"{substeps} steps per call, per step"]["ms"]
    print(f"bwd/fwd time ratio: {vg / fwd:.2f}  clip+AdamW+EMA: "
          f"{full - vg:.3f} ms  per-call saving of the fused call: "
          f"{full - fused:.3f} ms  imgs/s (fused): {batch / fused * 1e3:.2f}")
    return out


def main(argv=None, device: DeviceLike = None):
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["trace"] and len(argv) in (2, 3):
        steps = int(argv[2]) if len(argv) > 2 else None
        return summarise(newest_trace(argv[1]), steps)
    if argv[:1] == ["decompose"]:
        batch, base, s2d = ([int(a) for a in argv[1:]] + [8, 128, 1][len(argv) - 1:])[:3]
        return decompose(batch, base, s2d, device=device)
    raise SystemExit(__doc__)


if __name__ == "__main__":
    main()
