"""Where the time goes in the PyTorch port's train step, on the card: device
time by kernel and by kind over a window of train steps of args256syn128 at
full width (batch 8 of 256^2 phantoms, base 128, bf16, simplex noise,
clipped fused AdamW, EMA), from seeded random weights, and the device's
busy and idle share.

    python3 scripts/torch_train_profile.py [STEPS]

Run from the root of a checkout on a machine with a CUDA card.  Prints the
unprofiled step time, one line per kind, the 15 costliest kernels, and a
JSON summary as the last line.
"""
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from anoddpm_torch.campaigns.trace_categories import kind_of  # noqa: E402


def main():
    if not torch.cuda.is_available():
        print("torch_train_profile: CUDA is not available", file=sys.stderr)
        return 1
    import chip_smoke
    from anoddpm_torch import training
    from anoddpm_torch.config import load_args
    from anoddpm_torch.data.datasets import dataset_from_args
    from anoddpm_torch.data.pipeline import to_nchw
    from anoddpm_torch.ops.noise import sampler_from_args
    from anoddpm_torch.schedule import schedule_from_args

    steps = int(sys.argv[1]) if len(sys.argv) > 1 else 10
    args = load_args("256syn128", config_dir=os.path.join(ROOT, "configs"))
    model = chip_smoke.seeded_model(args)
    state = training.init_train_state(model, training.make_optimizer(
        model.parameters(), float(args["lr"])))
    sched = schedule_from_args(args).to("cuda")
    step = training.make_train_step(
        sched, sampler_from_args(args),
        max_t=min(int(args["sample_distance"]), sched.num_timesteps))
    ds = dataset_from_args(ROOT, args)
    batch_size = int(args["Batch_Size"])
    batch = to_nchw(np.stack([ds[i]["image"] for i in range(batch_size)])).cuda()
    gen = torch.Generator(device="cuda").manual_seed(0)

    def window(n):
        for _ in range(n):
            metrics = step(state, batch, gen)
        return metrics

    window(3)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    window(steps)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3 / steps
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        metrics = window(steps)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    loss = float(metrics["loss"])
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    if not kernels or not np.isfinite(loss):
        print(f"torch_train_profile: no device time or loss {loss}", file=sys.stderr)
        return 1
    by_kind = {}
    for e in kernels:
        k = kind_of(e.key)
        ms, n = by_kind.get(k, (0.0, 0))
        by_kind[k] = (ms + e.self_device_time_total / 1e3 / steps, n + e.count / steps)
    busy = sum(ms for ms, _ in by_kind.values())
    print(f"device: {torch.cuda.get_device_name(0)}")
    # The profiler slows the host, not the kernels, so the idle share of an
    # unprofiled step is the one that describes the real run.
    print(f"per train step (batch {batch_size}): wall {plain_ms:.3f} ms "
          f"unprofiled ({batch_size / plain_ms * 1e3:.2f} images/s), "
          f"{wall_ms:.3f} ms profiled; device busy {busy:.3f} ms, idle share "
          f"{1 - busy / plain_ms:.3f} of an unprofiled step "
          f"({1 - busy / wall_ms:.3f} of a profiled one); peak memory "
          f"{peak:.2f} GiB; loss {loss:.5f}")
    for k, (ms, n) in sorted(by_kind.items(), key=lambda kv: -kv[1][0]):
        print(f"  {k:34s} {ms:8.3f} ms/step  {n:7.1f} launches/step  "
              f"{ms / busy:6.1%} of device time")
    print("costliest kernels (ms per step, launches per step):")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:15]:
        print(f"  {e.self_device_time_total / 1e3 / steps:8.3f} "
              f"{e.count / steps:6.1f}  {e.key[:110]}")
    print(json.dumps({"steps": steps, "batch": batch_size,
                      "wall_ms_per_step": plain_ms,
                      "images_per_s": batch_size / plain_ms * 1e3,
                      "profiled_wall_ms_per_step": wall_ms,
                      "device_busy_ms_per_step": busy,
                      "idle_share": 1 - busy / plain_ms,
                      "peak_memory_gib": peak,
                      "kinds_ms_per_step": {k: v[0] for k, v in by_kind.items()},
                      "kinds_launches_per_step": {k: v[1] for k, v in by_kind.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
