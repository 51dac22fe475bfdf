"""Kernel K2b's device-only time per train step (batch 8, one call per
norm+SiLU site at its own shape and dtype) under several launch layouts and
in either order, on the card.

    python3 scripts/torch_k2b_layouts.py [--root DIR] [--sweep]
        [--order kernel|flax] [--configs 256syn128 256syn64s2d]
        [--dtype site|float32|bfloat16]

`--order flax` times K2b in flax's order (the JAX package's default
norm+SiLU) with `bf16_path` off and on; `--configs` picks the models whose
sites are timed; `--dtype` times the sites in their own dtype or all in
one.  `--sweep` times this checkout's kernel under each layout of LAYOUTS
besides the default one; `--root` times the K2b of another checkout of the
port (for example the parent commit unpacked with `git archive`) in turns
with this one (other, this, this, other) at every shape, checks that the
two give the same gradients within chip_smoke's K2b tolerances and reports
whether they give the same bits (dx, dgamma, dbeta; on the timed inputs
and on a wide gamma and beta).  A device copy of the
same bytes (read x and grad_out, write one tensor like dx) is timed beside
them, and the bytes bound of each shape is printed.  Each time is 20 calls
captured in a CUDA graph and replayed (`chip_smoke.graph_ms`); the host
microseconds per call come from `chip_smoke.host_us`, for both checkouts in
turns, before and after as many `torch.profiler` sessions as chip_smoke's
K2b phase runs.  Prints one line per layout, config and shape and a JSON
summary as the last line.
"""
import argparse
import importlib
import importlib.util
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KB = 1024
# (target slice bytes of x + grad_out, threads a block where both slices are
# staged, threads where grad_out is read twice, largest staged slice)
LAYOUTS = [(64 * KB, 256, 256, 96 * KB),
           (64 * KB, 256, 256, 128 * KB),   # 2 MB groups: both staged
           (64 * KB, 512, 512, 96 * KB),
           (64 * KB, 128, 128, 96 * KB),
           (32 * KB, 256, 512, 96 * KB),
           (64 * KB, 256, 512, 0)]          # nothing staged
KNOBS = ("BACKWARD_SLICE_BYTES", "BACKWARD_MAX_THREADS",
         "BACKWARD_MAX_THREADS_READ_TWICE", "BACKWARD_STAGE_MAX_BYTES")


def set_layout(gn, layout):
    """Set K2b's layout limits (KNOBS) and forget the plans made so far."""
    for knob, value in zip(KNOBS, layout):
        setattr(gn, knob, value)
    gn.backward_plan.cache_clear()
    gn._backward_launch_args.cache_clear()


def port_norm(root, alias):
    """`anoddpm_torch.ops.group_norm_silu` of the checkout at `root`,
    imported as package `alias` so that two checkouts live in one process."""
    pkg = os.path.join(root, "anoddpm_torch")
    spec = importlib.util.spec_from_file_location(
        alias, os.path.join(pkg, "__init__.py"),
        submodule_search_locations=[pkg])
    module = importlib.util.module_from_spec(spec)
    sys.modules[alias] = module
    spec.loader.exec_module(module)
    return importlib.import_module(f"{alias}.ops.group_norm_silu")


def inputs(torch, gn, shape, dtype, order="kernel"):
    """x, grad_out, gamma, beta, mean, rstd of one K2b call, from a seed
    (the statistics from K2 in `order`)."""
    gen = torch.Generator(device="cuda").manual_seed(shape[1] + shape[2])
    x = (torch.randn(shape, generator=gen, device="cuda") * 1.7 + 0.4).to(dtype)
    go = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    gamma = 1 + 0.1 * torch.randn(shape[1], generator=gen, device="cuda")
    beta = 0.1 * torch.randn(shape[1], generator=gen, device="cuda")
    _, mean, rstd = gn.group_norm_silu_with_stats(x, gamma, beta, order=order)
    return x, go, gamma, beta, mean, rstd


def agree(chip_smoke, torch, got, want):
    """Whether two K2b results agree within chip_smoke's K2b tolerances."""
    dx, wdx = got[0].float(), want[0].float()
    diff = (dx - wdx).abs()
    if got[0].dtype == torch.float32:
        tol = chip_smoke.K2B_TOL + chip_smoke.K2B_TOL * wdx.abs()
    else:
        tol = torch.clamp(chip_smoke.bf16_ulp(wdx), min=chip_smoke.K2B_TOL)
    rel = max(((g - w).abs().max() / w.abs().max().clamp_min(1e-30)).item()
              for g, w in zip(got[1:], want[1:]))
    return bool((diff <= tol).all()) and rel <= chip_smoke.K2B_TOL


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=None)
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--order", choices=("kernel", "flax"), default="kernel")
    ap.add_argument("--configs", nargs="+", default=["256syn128"])
    ap.add_argument("--dtype", choices=("site", "float32", "bfloat16"),
                    default="site")
    opts = ap.parse_args()
    sys.path.insert(0, HERE)
    import torch
    if not torch.cuda.is_available():
        print("torch_k2b_layouts: CUDA is not available", file=sys.stderr)
        return 1
    import chip_smoke
    from anoddpm_torch.config import load_args
    from anoddpm_torch.ops import group_norm_silu as gn
    other = port_norm(os.path.abspath(opts.root), "other_port") if opts.root else None
    chip_smoke.device_info()
    order = opts.order
    # the K2b calls of each variant: (order, bf16_path)
    variants = [(order, False)] + ([(order, True)] if order == "flax" else [])
    print(f"K2b in the {order} order, sites in dtype {opts.dtype}; other "
          f"checkout: {opts.root}", flush=True)
    summary, bits, agreed = {}, {}, True
    for config in opts.configs:
        args = load_args(config, config_dir=os.path.join(HERE, "configs"))
        model = chip_smoke.seeded_model(args)
        sites = [((chip_smoke.TRAIN_BATCH,) + s[1:],
                  dt if opts.dtype == "site" else getattr(torch, opts.dtype))
                 for s, dt in chip_smoke.k2_sites(model)]
        del model
        data = {key: inputs(torch, gn, *key, order) for key in set(sites)}
        # bytes bound: read x and grad_out, write dx
        bound = {key: 3 * d[0].numel() * d[0].element_size()
                 / chip_smoke.HBM_BYTES_PER_S * 1e3 for key, d in data.items()}
        top = max(k[0][2] for k in sites)
        big = lambda times: sum(times[s] for s in sites if s[0][2] == top)
        out = summary.setdefault(config, {"bound": sum(bound[s] for s in sites)})

        def per_step(name, fn):
            times = {key: chip_smoke.graph_ms(lambda: fn(*d))
                     for key, d in data.items()}
            total = sum(times[s] for s in sites)
            out[name] = total
            print(f"args{config} {name}: {total:.4f} ms per train step "
                  f"device-only, {out['bound'] / total:.1%} of the bound "
                  f"({big(times):.4f} ms in the calls at the largest H W)",
                  flush=True)
            return times

        for v_order, bf16_path in variants:
            tag = f"{v_order}" + (f", bf16_path={bf16_path}"
                                  if v_order == "flax" else "")
            call = lambda tree: (lambda *d: tree.group_norm_silu_backward(
                *d, order=v_order, bf16_path=bf16_path))
            layouts = [(tag, None)]
            if opts.sweep:
                layouts += [(f"{tag}: slice {b // KB} KB, {t} threads ({u} "
                             f"reading grad_out twice), staged <= {m // KB} KB",
                             layout)
                            for layout in LAYOUTS for b, t, u, m in [layout]]
            kept = tuple(getattr(gn, k) for k in KNOBS)
            for name, layout in layouts:
                set_layout(gn, layout or kept)
                times = per_step(name, call(gn))
                for (shape, dtype), ms in sorted(times.items(),
                                                 key=lambda kv: kv[0][0][1:]):
                    plan = gn.backward_plan(shape[0], shape[1],
                                            shape[2] * shape[3], dtype)
                    print(f"    {shape} {str(dtype)[6:]} {tuple(plan)}: "
                          f"{ms * 1e3:.2f} us, bound "
                          f"{bound[(shape, dtype)] * 1e3:.2f} us "
                          f"({bound[(shape, dtype)] / ms:.1%})", flush=True)
            set_layout(gn, kept)

            if other is not None:
                this_t, other_t, same = {}, {}, True
                for key, d in data.items():
                    fns = {"this": lambda: call(gn)(*d),
                           "other": lambda: call(other)(*d)}
                    o1, t1, t2, o2 = (chip_smoke.graph_ms(fns[w])
                                      for w in ("other", "this", "this", "other"))
                    this_t[key], other_t[key] = (t1 + t2) / 2, (o1 + o2) / 2
                    got, want = fns["this"](), fns["other"]()
                    agreed &= agree(chip_smoke, torch, got, want)
                    same &= all(torch.equal(a, b) for a, b in zip(got, want))
                    # a wide gamma and beta: the norm's output h across
                    # |h| < 2^-8 .. 2^9
                    wide = (d[0], d[1], 60 * d[2], 40 * d[3], d[4], d[5])
                    same &= all(torch.equal(a, b) for a, b in zip(
                        call(gn)(*wide), call(other)(*wide)))
                for name, times in (("this, in turns", this_t),
                                    ("other, in turns", other_t)):
                    total = sum(times[s] for s in sites)
                    out[f"{tag}: {name}"] = total
                    print(f"args{config} {tag}: {name}: {total:.4f} ms per train "
                          f"step device-only ({big(times):.4f} ms at the "
                          f"largest H W)", flush=True)
                for key in sorted(data, key=lambda k: k[0][1:]):
                    print(f"    {key[0]} {str(key[1])[6:]}: this "
                          f"{this_t[key] * 1e3:.2f} us, other "
                          f"{other_t[key] * 1e3:.2f} us", flush=True)
                bits[f"{config} {tag}"] = bool(same)
                print(f"args{config} {tag}: dx, dgamma and dbeta bit-identical "
                      f"to the other checkout's at every shape: {same}",
                      flush=True)

        # the same bytes moved by the card: read x and grad_out, write a
        # tensor like dx
        outs = {key: torch.empty_like(d[0]) for key, d in data.items()}
        per_step("copy of the same bytes",
                 lambda x, go, *_: torch.add(
                     x, go, out=outs[(tuple(x.shape), x.dtype)]))
        del data, outs
        torch.cuda.empty_cache()
    if other is not None:
        print(f"other's gradients agree with this one's: {agreed}")

    # host us per call, with the other checkout in turns, before and after
    # as many torch.profiler sessions as chip_smoke's K2b phase runs
    trees = {"this": gn, "other": other}
    turns = ("other", "this", "this", "other") if other else ("this",)
    small = inputs(torch, gn, chip_smoke.K2B_HOST_SHAPE, torch.bfloat16, order)
    host = {}
    for point in ("before the profiler", "after the profiler"):
        if point == "after the profiler":
            for _ in range(2 * len(set(sites))):
                chip_smoke.profiled_device_ms(
                    lambda: gn.group_norm_silu_backward(*small, order=order))
        reads = {}
        for w in turns:
            reads.setdefault(w, []).append(chip_smoke.host_us(
                lambda: trees[w].group_norm_silu_backward(*small, order=order)))
        host[point] = {w: sum(v) / len(v) for w, v in reads.items()}
        print(f"host, {point}: " + ", ".join(
            f"{w} {us:.2f}" for w, us in host[point].items())
            + f" us per K2b call at {chip_smoke.K2B_HOST_SHAPE} bf16", flush=True)
    print(json.dumps({"root": opts.root, "order": order, "dtype": opts.dtype,
                      "ms_per_train_step": summary, "bit_identical": bits,
                      "host_us_per_call": host}))
    return 0 if agreed and all(bits.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
