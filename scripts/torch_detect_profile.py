"""Where the time goes in the PyTorch port's detection reverse steps, on the
card: device time by kernel and by kind over a window of reverse steps of
args256syn128 at full width (4 slices of 256^2, base 128, bf16, simplex
noise), with seeded random weights, and the device's busy and idle share.

    python3 scripts/torch_detect_profile.py [STEPS]

Run from the root of a checkout on a machine with a CUDA card.  Prints one
line per kind, the 15 costliest kernels, and a JSON summary as the last line.
"""
import json
import os
import re
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

KINDS = [  # first match wins
    ("K1 simplex field", r"octave_field"),
    ("K2 group_norm_silu", r"partial_sums_kernel|finalize_kernel|apply_kernel"),
    ("conv", r"conv|fprop|implicit|dgrad|wgrad"),
    ("layout transpose", r"nchwToNhwc|nhwcToNchw|nchw.*nhwc|nhwc.*nchw"),
    ("matmul", r"gemm|cutlass|xmma"),
    ("softmax", r"softmax"),
    ("elementwise", r"elementwise|CatArrayBatched|index"),
    ("reduction", r"reduce"),
]


def kind_of(name):
    for kind, pattern in KINDS:
        if re.search(pattern, name, re.IGNORECASE):
            return kind
    return "other"


def main():
    if not torch.cuda.is_available():
        print("torch_detect_profile: CUDA is not available", file=sys.stderr)
        return 1
    import chip_smoke
    from anoddpm_torch import diffusion
    from anoddpm_torch.config import load_args
    from anoddpm_torch.data.datasets import anomalous_dataset_from_args
    from anoddpm_torch.ops.noise import sampler_from_args
    from anoddpm_torch.schedule import schedule_from_args

    steps = int(sys.argv[1]) if len(sys.argv) > 1 else 10
    args = load_args("256syn128", config_dir=os.path.join(ROOT, "configs"))
    model = chip_smoke.seeded_model(args)
    sched = schedule_from_args(args).to("cuda")
    sampler = sampler_from_args(args)
    image = anomalous_dataset_from_args(ROOT, args)[0]["image"]
    x = torch.from_numpy(image.transpose(0, 3, 1, 2).copy()).cuda()
    gen = torch.Generator(device="cuda").manual_seed(0)
    chain = lambda n: diffusion.denoise_chain(model, sched, x, n, gen, sampler)
    with torch.inference_mode():
        chain(3)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        chain(steps)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3 / steps
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            chain(steps)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    if not kernels:
        print("torch_detect_profile: the profiler saw no device time", file=sys.stderr)
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
    print(f"per reverse step: wall {plain_ms:.3f} ms unprofiled, {wall_ms:.3f} ms "
          f"profiled; device busy {busy:.3f} ms, idle share "
          f"{1 - busy / plain_ms:.3f} of an unprofiled step "
          f"({1 - busy / wall_ms:.3f} of a profiled one)")
    for k, (ms, n) in sorted(by_kind.items(), key=lambda kv: -kv[1][0]):
        print(f"  {k:20s} {ms:8.3f} ms/step  {n:7.1f} launches/step  "
              f"{ms / busy:6.1%} of device time")
    print("costliest kernels (ms per step, launches per step):")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:15]:
        print(f"  {e.self_device_time_total / 1e3 / steps:8.3f} "
              f"{e.count / steps:6.1f}  {e.key[:110]}")
    print(json.dumps({"steps": steps, "wall_ms_per_step": plain_ms,
                      "profiled_wall_ms_per_step": wall_ms,
                      "device_busy_ms_per_step": busy,
                      "idle_share": 1 - busy / plain_ms,
                      "kinds_ms_per_step": {k: v[0] for k, v in by_kind.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
