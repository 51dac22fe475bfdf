"""Train steps of several seeds at once on one card, against one seed alone:

    python3 scripts/torch_concurrent_seeds.py [--procs 1 3 5] [--dispatches 12]
        [--norm-order kernel|flax] [--out results/torch_concurrent_seeds.jsonl]

For each count N of `--procs`, N processes start together, each building
args256syn64s2d's train state for its own seed as
`campaigns.seed_replication` trains it (8 substeps a dispatch, batch 8, the
order of `--norm-order`) and timing `--dispatches` dispatches on seeded
random batches after 2 of warm-up.  A step is host-bound at batch 8 (one
seed's training alone draws 72-200 W of the card's 700 W: the smi logs in
results/torch_f3_seeds/), so processes that share the card can fill its
idle time: the line per N gives each process's ms per step and the steps
per second of all of them together.  Run from the root of a checkout on a
machine with a card.
"""

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.getcwd())

CONFIG = "256syn64s2d"


def child(seed, dispatches, norm_order):
    import torch
    from anoddpm_torch.campaigns.seed_replication import train_args_for
    from anoddpm_torch.ops.noise import sampler_from_args
    from anoddpm_torch.schedule import schedule_from_args
    from anoddpm_torch.train import new_train_state
    from anoddpm_torch.training import make_multi_step, make_train_step
    device = torch.device("cuda")
    args = train_args_for(CONFIG, seed, ".", norm_order)
    sched = schedule_from_args(args).to(device)
    state = new_train_state(args, device)
    substeps = int(args["train_substeps"])
    step = make_multi_step(make_train_step(
        sched, sampler_from_args(args),
        max_t=min(int(args["sample_distance"]), sched.num_timesteps)), substeps)
    gen = torch.Generator(device=device).manual_seed(seed)
    size = (substeps, int(args["Batch_Size"]), 1, *args["img_size"])
    batches = [torch.rand(size, generator=gen, device=device) * 2 - 1
               for _ in range(2)]
    for i in range(2):
        step(state, batches[i % 2], gen)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(dispatches):
        metrics = step(state, batches[i % 2], gen)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    assert torch.isfinite(metrics["loss"]).item()
    print(json.dumps({"seed": seed, "ms_per_step":
                      wall / (dispatches * substeps) * 1e3}), flush=True)


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--procs", nargs="*", type=int, default=[1, 3, 5])
    p.add_argument("--dispatches", type=int, default=12)
    p.add_argument("--norm-order", default="flax")
    p.add_argument("--out", default="results/torch_concurrent_seeds.jsonl")
    p.add_argument("--child", type=int, default=None)
    ns = p.parse_args()
    if ns.child is not None:
        return child(ns.child, ns.dispatches, ns.norm_order)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    for n in ns.procs:
        procs = [subprocess.Popen(
            [sys.executable, __file__, "--child", str(s), "--dispatches",
             str(ns.dispatches), "--norm-order", ns.norm_order],
            stdout=subprocess.PIPE, text=True) for s in range(n)]
        rows = []
        for proc in procs:
            out, _ = proc.communicate()
            if proc.returncode:
                raise SystemExit(f"a child exited {proc.returncode}")
            rows.append(json.loads(out.strip().splitlines()[-1]))
        ms = [r["ms_per_step"] for r in rows]
        line = {"config": CONFIG, "norm_order": ns.norm_order, "procs": n,
                "ms_per_step": ms, "steps_per_sec": sum(1e3 / m for m in ms),
                "card": card}
        print(json.dumps(line), flush=True)
        os.makedirs(os.path.dirname(ns.out) or ".", exist_ok=True)
        with open(ns.out, "a") as f:
            f.write(json.dumps(line) + "\n")


if __name__ == "__main__":
    main()
