"""Kernel K2's device-only time per UNet forward (batch 4, one call per
norm+SiLU site at its own shape and dtype) under several launch layouts and
in either order, on the card.

    python3 scripts/torch_k2_layouts.py [--root DIR] [--sweep]
        [--order kernel|flax] [--configs 256syn128 256syn64s2d]
        [--dtype site|float32|bfloat16]

`--order` picks K2's order (its own, or flax's: the JAX package's default
norm+SiLU); `--configs` the models whose sites are timed; `--dtype` times
the sites in their own dtype or all in one.  `--root` times the K2 of another
checkout of the port (for example the parent commit unpacked with `git
archive`) in turns with this one at every shape (other, this, this, other)
and checks that the two give the same bits (out, mean, rstd; on the timed
inputs and on a wide gamma and beta); `--sweep`
times this checkout's kernel under each layout of LAYOUTS besides the
default one.  A copy of the same bytes (`copy_`) is timed beside them.  Each
time is 20 calls captured in a CUDA graph and replayed
(`chip_smoke.graph_ms`); the host microseconds per call come from
`chip_smoke.host_us` at `chip_smoke.K2_HOST_SHAPE` in bf16, for both
checkouts in turns.  Prints one line per layout, config and shape and a
JSON summary as the last line.
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
DTYPES = ("site", "float32", "bfloat16")


def load_sibling(name):
    """scripts/{name}.py as a module."""
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(HERE, "scripts", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def site_keys(chip_smoke, torch, config, dtype):
    """(shape, dtype) of each K2 call of a forward of args{config}'s UNet at
    chip_smoke.BATCH, in `dtype` ("site": the call's own)."""
    from anoddpm_torch.config import load_args
    args = load_args(config, config_dir=os.path.join(HERE, "configs"))
    model = chip_smoke.seeded_model(args)
    sites = chip_smoke.k2_sites(model)
    del model
    torch.cuda.empty_cache()
    if dtype != "site":
        sites = [(s, getattr(torch, dtype)) for s, _ in sites]
    return sites


def inputs(torch, shape, dtype):
    """x, gamma, beta of one K2 call, from a seed."""
    gen = torch.Generator(device="cuda").manual_seed(shape[1] + shape[2] + 12)
    x = (torch.randn(shape, generator=gen, device="cuda") * 1.7 + 0.4).to(dtype)
    gamma = 1 + 0.1 * torch.randn(shape[1], generator=gen, device="cuda")
    beta = 0.1 * torch.randn(shape[1], generator=gen, device="cuda")
    return x, gamma, beta


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=None)
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--order", choices=("kernel", "flax"), default="kernel")
    ap.add_argument("--configs", nargs="+", default=["256syn128"])
    ap.add_argument("--dtype", choices=DTYPES, default="site")
    opts = ap.parse_args()
    sys.path.insert(0, HERE)
    import torch
    if not torch.cuda.is_available():
        print("torch_k2_layouts: CUDA is not available", file=sys.stderr)
        return 1
    import chip_smoke
    from anoddpm_torch.ops import group_norm_silu as gn
    other = (load_sibling("torch_k2b_layouts").port_norm(
        os.path.abspath(opts.root), "other_port") if opts.root else None)
    chip_smoke.device_info()
    order = opts.order
    print(f"K2 in the {order} order, sites in dtype {opts.dtype}; other "
          f"checkout: {opts.root}", flush=True)
    summary, bits = {}, {}
    for config in opts.configs:
        sites = site_keys(chip_smoke, torch, config, opts.dtype)
        data = {key: inputs(torch, *key) for key in set(sites)}
        total = lambda times: sum(times[s] for s in sites)
        big = lambda times: sum(times[s] for s in sites if s[0][2] == max(
            k[0][2] for k in sites))
        out = summary.setdefault(config, {})

        layouts = [("default", None)]
        if opts.sweep:
            layouts += [(f"slice {b // KB} KB, {t} threads, cluster <= {c}, "
                         f"staged <= {m // KB} KB", layout)
                        for layout in LAYOUTS for b, t, c, m in [layout]]
        kept = (gn.SLICE_BYTES, gn.MAX_THREADS, gn.MAX_CLUSTER,
                gn.STAGE_MAX_BYTES)
        for name, layout in layouts:
            (gn.SLICE_BYTES, gn.MAX_THREADS, gn.MAX_CLUSTER,
             gn.STAGE_MAX_BYTES) = layout or kept
            gn.plan.cache_clear()
            gn._launch_args.cache_clear()
            times = {key: chip_smoke.graph_ms(
                lambda: gn.group_norm_silu(*d, order=order))
                for key, d in data.items()}
            out[name] = total(times)
            print(f"args{config} {name}: {total(times):.4f} ms per forward "
                  f"device-only ({big(times):.4f} ms in the calls at the "
                  f"largest H W)", flush=True)
            for (shape, dtype), ms in sorted(times.items(),
                                             key=lambda kv: kv[0][0][1:]):
                print(f"    {shape} {str(dtype)[6:]}: {ms * 1e3:.2f} us",
                      flush=True)
        (gn.SLICE_BYTES, gn.MAX_THREADS, gn.MAX_CLUSTER,
         gn.STAGE_MAX_BYTES) = kept
        gn.plan.cache_clear()
        gn._launch_args.cache_clear()

        if other is not None:
            this_t, other_t, same = {}, {}, True
            for key, d in data.items():
                fns = {"this": lambda: gn.group_norm_silu(*d, order=order),
                       "other": lambda: other.group_norm_silu(*d, order=order)}
                o1, t1, t2, o2 = (chip_smoke.graph_ms(fns[w])
                                  for w in ("other", "this", "this", "other"))
                this_t[key], other_t[key] = (t1 + t2) / 2, (o1 + o2) / 2
                # the timed inputs, and a wide gamma and beta that put the
                # norm's output h across |h| < 2^-8 .. 2^9
                for x, gamma, beta in (d, (d[0], 60 * d[1], 40 * d[2])):
                    got = gn.group_norm_silu_with_stats(x, gamma, beta,
                                                        order=order)
                    want = other.group_norm_silu_with_stats(x, gamma, beta,
                                                            order=order)
                    same &= all(torch.equal(a, b) for a, b in zip(got, want))
            for name, times in (("this, in turns", this_t),
                                ("other, in turns", other_t)):
                out[name] = total(times)
                print(f"args{config} {name}: {total(times):.4f} ms per forward "
                      f"device-only ({big(times):.4f} ms at the largest H W)",
                      flush=True)
            for key in sorted(data, key=lambda k: k[0][1:]):
                print(f"    {key[0]} {str(key[1])[6:]}: this "
                      f"{this_t[key] * 1e3:.2f} us, other "
                      f"{other_t[key] * 1e3:.2f} us", flush=True)
            bits[config] = bool(same)
            print(f"args{config}: out, mean and rstd bit-identical to the "
                  f"other checkout's at every shape: {same}", flush=True)

        # the same bytes moved by a plain copy: what the card's memory gives
        # a kernel that reads x once and writes out once
        times = {key: chip_smoke.graph_ms(
            lambda: torch.empty_like(d[0]).copy_(d[0]))
            for key, d in data.items()}
        out["copy"] = total(times)
        print(f"args{config} copy of the same bytes: {total(times):.4f} ms per "
              f"forward device-only", flush=True)
        del data
        torch.cuda.empty_cache()

    x, gamma, beta = inputs(torch, chip_smoke.K2_HOST_SHAPE, torch.bfloat16)
    trees = {"this": gn, "other": other}
    reads = {}
    for w in (("other", "this", "this", "other") if other else ("this",)):
        reads.setdefault(w, []).append(chip_smoke.host_us(
            lambda: trees[w].group_norm_silu(x, gamma, beta, order=order)))
    host = {w: sum(v) / len(v) for w, v in reads.items()}
    print("host: " + ", ".join(f"{w} {us:.2f}" for w, us in host.items())
          + f" us per K2 call at {chip_smoke.K2_HOST_SHAPE} bf16", flush=True)
    print(json.dumps({"root": opts.root, "order": order, "dtype": opts.dtype,
                      "ms_per_forward": summary, "bit_identical": bits,
                      "host_us_per_call": host}))
    return 0 if all(bits.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
