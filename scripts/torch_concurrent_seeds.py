"""Train steps of several seeds at once on one card, against one seed alone:

    python3 scripts/torch_concurrent_seeds.py [--config 256syn64s2d|256syn128]
        [--procs 1 3 5] [--dispatches 12] [--norm-order kernel|flax|jax_rng]
        [--out results/torch_concurrent_seeds.jsonl]

For each count N of `--procs`, N processes start together, each building
the config's train state for its own seed as `campaigns.seed_replication`
trains it (8 substeps a dispatch, batch 8, the order of `--norm-order`;
`jax_rng` is the flax order on the JAX package's draws) and timing
`--dispatches` dispatches of the trainer's own call (`train.dispatch_of`
on `train.loop_stream`) on seeded random batches after 2 of warm-up.
Each process also reports its peak device memory, and the line per N the
seconds per epoch (the config's `iters_per_epoch` steps; the VLB sweeps,
checkpoints and the test-set suite are not in it).  At s2d64 a step is
host-bound at batch 8 (one seed's training alone draws 72-200 W of the
card's 700 W: the smi logs in results/torch_f3_seeds/), so processes that
share the card can fill its idle time: the line per N gives each
process's ms per step and the steps per second of all of them together.
Run from the root of a checkout on a machine with a card.
"""

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.getcwd())


def child(config, seed, dispatches, norm_order):
    import torch
    from anoddpm_torch.campaigns.seed_replication import train_args_for
    from anoddpm_torch.ops.noise import sampler_from_args
    from anoddpm_torch.schedule import schedule_from_args
    from anoddpm_torch.train import dispatch_of, loop_stream, new_train_state
    device = torch.device("cuda")
    args = train_args_for(config, seed, ".", norm_order)
    sched = schedule_from_args(args).to(device)
    state = new_train_state(args, device)
    substeps = int(args["train_substeps"])
    step, _ = dispatch_of(args, sched, sampler_from_args(args))
    stream = loop_stream(args, device)
    gen = torch.Generator(device=device).manual_seed(seed)
    size = (substeps, int(args["Batch_Size"]), 1, *args["img_size"])
    batches = [torch.rand(size, generator=gen, device=device) * 2 - 1
               for _ in range(2)]
    torch.cuda.reset_peak_memory_stats()
    for i in range(2):
        step(state, batches[i % 2], stream)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(dispatches):
        metrics = step(state, batches[i % 2], stream)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    assert torch.isfinite(metrics["loss"]).item()
    print(json.dumps({"seed": seed, "ms_per_step":
                      wall / (dispatches * substeps) * 1e3,
                      "iters_per_epoch": int(args["iters_per_epoch"]),
                      "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}),
          flush=True)


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--config", default="256syn64s2d")
    p.add_argument("--procs", nargs="*", type=int, default=[1, 3, 5])
    p.add_argument("--dispatches", type=int, default=12)
    p.add_argument("--norm-order", default="flax")
    p.add_argument("--out", default="results/torch_concurrent_seeds.jsonl")
    p.add_argument("--child", type=int, default=None)
    ns = p.parse_args()
    if ns.child is not None:
        return child(ns.config, ns.child, ns.dispatches, ns.norm_order)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    for n in ns.procs:
        procs = [subprocess.Popen(
            [sys.executable, __file__, "--child", str(s), "--dispatches",
             str(ns.dispatches), "--norm-order", ns.norm_order,
             "--config", ns.config],
            stdout=subprocess.PIPE, text=True) for s in range(n)]
        rows = []
        for proc in procs:
            out, _ = proc.communicate()
            if proc.returncode:
                raise SystemExit(f"a child exited {proc.returncode}")
            rows.append(json.loads(out.strip().splitlines()[-1]))
        ms = [r["ms_per_step"] for r in rows]
        line = {"config": ns.config, "norm_order": ns.norm_order, "procs": n,
                "ms_per_step": ms, "steps_per_sec": sum(1e3 / m for m in ms),
                "s_per_epoch": [m * r["iters_per_epoch"] / 1e3
                                for m, r in zip(ms, rows)],
                "peak_gib": [r["peak_gib"] for r in rows], "card": card}
        print(json.dumps(line), flush=True)
        os.makedirs(os.path.dirname(ns.out) or ".", exist_ok=True)
        with open(ns.out, "a") as f:
            f.write(json.dumps(line) + "\n")


if __name__ == "__main__":
    main()
