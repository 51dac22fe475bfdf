"""Kernel K2's device-only time per args256syn128 UNet forward (batch 4, 85
calls at their own shapes and dtypes) under several launch layouts, on the
card.

    python3 scripts/torch_k2_layouts.py [--root DIR] [--sweep]

`--root` times the K2 of another checkout of the port (for example an older
commit unpacked with `git archive`) with its own layout; `--sweep` times this
checkout's kernel under each layout of LAYOUTS besides the default one.  A
copy of the same bytes (`copy_`) is timed beside them.  Each time is 20 calls
captured in a CUDA graph and replayed (`chip_smoke.graph_ms`); the host
microseconds per call come from `chip_smoke.k2_host_us`.  Prints one line per
layout and a JSON summary as the last line.
"""
import argparse
import importlib.util
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KB = 1024
# (target slice bytes, threads a block, largest cluster, largest staged slice)
LAYOUTS = [(16 * KB, 256, 16, 96 * KB), (32 * KB, 256, 16, 96 * KB),
           (64 * KB, 128, 16, 96 * KB), (64 * KB, 256, 16, 0),
           (128 * KB, 256, 8, 128 * KB)]


def per_forward_ms(fn, sites, torch, graph_ms):
    """Sum of device-only ms of fn(x, gamma, beta) over the forward's K2
    calls, timing each distinct (shape, dtype) once."""
    gen = torch.Generator(device="cuda").manual_seed(12)
    times = {}
    for shape, dtype in set(sites):
        x = (torch.randn(shape, generator=gen, device="cuda") * 1.7 + 0.4).to(dtype)
        gamma = 1 + 0.1 * torch.randn(shape[1], generator=gen, device="cuda")
        beta = 0.1 * torch.randn(shape[1], generator=gen, device="cuda")
        times[(shape, dtype)] = graph_ms(lambda: fn(x, gamma, beta))
    return sum(times[s] for s in sites), times


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--sweep", action="store_true")
    opts = ap.parse_args()
    root = os.path.abspath(opts.root)
    sys.path.insert(0, root)   # the port whose K2 is timed
    import torch
    if not torch.cuda.is_available():
        print("torch_k2_layouts: CUDA is not available", file=sys.stderr)
        return 1
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    from anoddpm_torch.config import load_args
    from anoddpm_torch.ops import group_norm_silu as gn
    args = load_args("256syn128", config_dir=os.path.join(HERE, "configs"))
    sites = chip_smoke.k2_sites(chip_smoke.seeded_model(args))
    print(f"device: {torch.cuda.get_device_name(0)}; K2 of {root}")
    layouts = [("default", None)]
    if opts.sweep:
        layouts += [(f"slice {b // KB} KB, {t} threads, cluster <= {c}, "
                     f"staged <= {m // KB} KB", layout)
                    for layout in LAYOUTS for b, t, c, m in [layout]]
    summary = {}
    for name, layout in layouts:
        if layout is not None:
            (gn.SLICE_BYTES, gn.MAX_THREADS, gn.MAX_CLUSTER,
             gn.STAGE_MAX_BYTES) = layout
            gn.plan.cache_clear()
            gn._launch_args.cache_clear()
        total, times = per_forward_ms(gn.group_norm_silu, sites, torch,
                                      chip_smoke.graph_ms)
        summary[name] = total
        big = sum(times[s] for s in sites if s[0][2] == 256)
        print(f"{name}: {total:.4f} ms per forward device-only "
              f"({big:.4f} ms in the 13 calls at 256^2)", flush=True)
        for (shape, dtype), ms in sorted(times.items(), key=lambda kv: kv[0][0][1:]):
            print(f"    {shape} {str(dtype)[6:]}: {ms * 1e3:.2f} us", flush=True)
    # the same bytes moved by a plain copy: what the card's memory gives a
    # kernel that reads x once and writes out once
    total, times = per_forward_ms(lambda x, g, b: torch.empty_like(x).copy_(x),
                                  sites, torch, chip_smoke.graph_ms)
    big = sum(times[s] for s in sites if s[0][2] == 256)
    summary["copy"] = total
    print(f"copy of the same bytes: {total:.4f} ms per forward device-only "
          f"({big:.4f} ms in the 13 calls at 256^2)", flush=True)
    host, lib_host = chip_smoke.k2_host_us()
    print(f"host: {host:.2f} us per K2 call, {lib_host:.2f} us per library "
          f"call at {chip_smoke.K2_HOST_SHAPE} bf16")
    print(json.dumps({"root": root, "ms_per_forward": summary,
                      "host_us_per_call": host}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
