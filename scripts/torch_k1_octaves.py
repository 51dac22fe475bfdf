"""Kernel K1 (simplex octave field) octave by octave, on the card: where its
time goes against its instruction-issue bound, and how many warps hold
pixels of more than one region of the lattice cell.

    python3 scripts/torch_k1_octaves.py [--root DIR] [--reps N]

For each octave o = 0..5 of the main path (4 fields of 256^2, frequency 64,
persistence 0.8), a single-octave field at frequency 64 / 2^o, which is
octave o's scale, is timed device-only (`chip_smoke.graph_ms`: calls
captured in a CUDA graph and replayed) and held against the plain version;
beside it stand the octave's instruction count (`chip_smoke.k1_instructions`),
its issue bound and the share of it reached, and the share of warps whose
pixels lie in more than one region, for this kernel's 8 x 4 warp tiles and
for warps of 32 pixels of one row.  Then the main path's 6-octave field,
the kernel's registers, spills and occupancy, the time of a launch that
computes one warp tile of one octave, nvidia-smi's SM clock while the
kernel runs back to back, and the host microseconds per call at n = 4, 16^2.

`--root` names another checkout of the port (for example an older commit
unpacked with `git archive`): its K1 is built from its own sources and timed
in the same run, in turns with this checkout's (other, this, this, other).
A variant of the kernel (another launch shape, another walk) is timed the
same way, from a copy of the checkout with its source edited.
Prints one line per measurement and a JSON summary as the last line.
"""
import argparse
import importlib
import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, HW, FREQ, PERSISTENCE, OCTAVES = 4, (256, 256), 64.0, 0.8, 6
T = [0.0, 57.0, 123.0, 199.0]


def port_simplex(root, alias):
    """`anoddpm_torch.ops.simplex` of the checkout at `root`, imported as
    package `alias` so that two checkouts live in one process."""
    pkg = os.path.join(root, "anoddpm_torch")
    spec = importlib.util.spec_from_file_location(
        alias, os.path.join(pkg, "__init__.py"),
        submodule_search_locations=[pkg])
    module = importlib.util.module_from_spec(spec)
    sys.modules[alias] = module
    spec.loader.exec_module(module)
    return importlib.import_module(f"{alias}.ops.simplex")


def mixed_share(region, warp_h, warp_w):
    """Share of warps of warp_h x warp_w pixels holding more than one
    region code; region is (n, H, W) with H, W multiples of the tile."""
    n, h, w = region.shape
    tiles = region.view(n, h // warp_h, warp_h, w // warp_w, warp_w)
    tiles = tiles.permute(0, 1, 3, 2, 4).reshape(-1, warp_h * warp_w)
    return (tiles.amin(dim=1) != tiles.amax(dim=1)).float().mean().item()


def region_codes(sx, t, scale):
    """0 for region 1 (in_sum <= 1), 1 for region 2 (>= 2), 2 for the
    octahedron, per pixel of the (n, H, W) plane at this scale."""
    import torch
    h, w = HW
    yy = torch.arange(h, dtype=torch.float32, device=t.device).view(1, h, 1)
    xx = torch.arange(w, dtype=torch.float32, device=t.device).view(1, 1, w)
    x, y, z = torch.broadcast_tensors(xx * scale, yy * scale,
                                      t.view(-1, 1, 1) * scale)
    _, _, in_sum = sx._skew(x, y, z)
    return torch.where(in_sum <= 1.0, 0, torch.where(in_sum >= 2.0, 1, 2))


def in_turns(this, other, timer):
    """(this ms, other ms), timed other, this, this, other when there is
    another checkout, each the mean of its two readings."""
    if other is None:
        return timer(this), None
    o1, t1, t2, o2 = timer(other), timer(this), timer(this), timer(other)
    return (t1 + t2) / 2, (o1 + o2) / 2


def sm_clock_under_load(torch, fn, seconds=1.0):
    """nvidia-smi's SM clock, power draw and limit, read halfway through
    `seconds` of fn() back to back."""
    import time
    fn()
    torch.cuda.synchronize()
    start = time.time()
    while time.time() - start < seconds / 2:
        for _ in range(200):
            fn()
        torch.cuda.synchronize()
    query = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw,power.limit",
         "--format=csv,noheader"], stdout=subprocess.PIPE, text=True)
    while query.poll() is None or time.time() - start < seconds:
        for _ in range(200):
            fn()
        torch.cuda.synchronize()
    return query.communicate()[0].strip()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=None,
                    help="another checkout whose K1 is timed in turns")
    ap.add_argument("--reps", type=int, default=20,
                    help="calls per CUDA graph")
    opts = ap.parse_args()
    sys.path.insert(0, HERE)
    import torch
    if not torch.cuda.is_available():
        print("torch_k1_octaves: CUDA is not available", file=sys.stderr)
        return 1
    import chip_smoke
    from anoddpm_torch.ops import simplex as sx
    other = (port_simplex(os.path.abspath(opts.root), "other_port")
             if opts.root else None)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}; "
          f"other checkout: {opts.root}", flush=True)
    print(f"K1 attributes: {sx.attributes(0)}", flush=True)
    other_attr = (other.attributes(0)._asdict()
                  if hasattr(other, "attributes") else None)
    if other_attr:
        print(f"other checkout's K1 attributes: {other_attr}", flush=True)

    gen = torch.Generator(device="cuda").manual_seed(11)
    seeds = torch.randint(0, 1 << 32, (N,), generator=gen, device="cuda",
                          dtype=torch.int64)
    t = torch.tensor(T, device="cuda")
    timer = lambda fn: chip_smoke.graph_ms(fn, reps=opts.reps)

    def field(mod, hw, octaves, freq):
        return lambda: mod.batched_fractal3_fixed_t(seeds, t, hw, octaves,
                                                    PERSISTENCE, freq)

    rows = []
    cases = [(o, 1, FREQ / 2 ** o) for o in range(OCTAVES)]
    cases.append(("all", OCTAVES, FREQ))
    def mismatch(mod, octaves, freq, want):
        got = field(mod, HW, octaves, freq)()
        return ((got - want).abs() > chip_smoke.K1_TOL).float().mean().item()

    for octave, octaves, freq in cases:
        want = sx._fractal3_fixed_t_plain(seeds, t, HW, octaves, PERSISTENCE,
                                          freq)
        off = mismatch(sx, octaves, freq, want)
        other_off = other and mismatch(other, octaves, freq, want)
        ms, other_ms = in_turns(field(sx, HW, octaves, freq),
                                other and field(other, HW, octaves, freq),
                                timer)
        count = chip_smoke.k1_instructions(t, HW, octaves, freq)
        bound = chip_smoke.issue_bound_ms(count)
        row = dict(octave=octave, frequency=freq, ms=ms, other_ms=other_ms,
                   bound_ms=bound, share=bound / ms,
                   instructions=sum(count.values()), mismatch=off,
                   other_mismatch=other_off)
        if octaves == 1:
            region = region_codes(sx, t, 1.0 / freq)
            row["mixed_8x4"] = mixed_share(region, 4, 8)
            row["mixed_32x1"] = mixed_share(region, 1, 32)
        rows.append(row)
        print(" ".join(f"{k} {v:.4g}" if isinstance(v, float) else f"{k} {v}"
                       for k, v in row.items()), flush=True)

    launch = lambda mod: (lambda: mod.batched_fractal3_fixed_t(
        seeds[:1], t[:1], (sx.TILE_H, sx.TILE_W), 1, PERSISTENCE, FREQ))
    floor_ms, other_floor_ms = in_turns(launch(sx), other and launch(other),
                                        timer)
    print(f"one warp tile, one octave (the cost of a launch): {floor_ms:.5f} ms"
          + ("" if other is None else f"; other checkout {other_floor_ms:.5f} ms"),
          flush=True)
    clocks = sm_clock_under_load(torch, field(sx, HW, OCTAVES, FREQ))
    print(f"SM clock while K1 runs back to back: {clocks}", flush=True)
    small = lambda mod: field(mod, (16, 16), OCTAVES, FREQ)
    host, other_host = in_turns(small(sx), other and small(other),
                                chip_smoke.host_us)
    print(f"host: {host:.2f} us per call at n={N} 16x16"
          + ("" if other is None else f"; other checkout {other_host:.2f} us"),
          flush=True)
    print(json.dumps({"device": torch.cuda.get_device_name(0), "smi": smi,
                      "other": opts.root, "attributes": sx.attributes(0)._asdict(),
                      "other_attributes": other_attr,
                      "rows": rows, "host_us": host, "sm_clock": clocks,
                      "launch_ms": floor_ms, "other_launch_ms": other_floor_ms,
                      "other_host_us": other_host}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
