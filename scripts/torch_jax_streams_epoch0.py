"""Epoch 0 of a band recipe on the JAX package's draws, per seed, against
the JAX package's TPU logs: the gate that decides which of the port's
JAX-stream seeds pair with their JAX twins.

    python3 scripts/torch_jax_streams_epoch0.py [--config 256syn64s2d|256syn128]
        [--seeds 0 1 2 3 4] [--device cuda|cpu] [--small] [--jax-side]
        [--set KEY=VALUE ...] [--root DIR] [--out PATH]

For each seed S the port trains the config's band recipe
(`campaigns.seed_replication.train_args_for(..., "jax_rng")`: the flax
norm order, 8 substeps, `rng: "jax"`) for epoch 0 only (2 dispatches
of 8 steps, then the epoch-0 VLB sweep), through `train.train`, and reads
its epoch-0 loss (the train JSONL) and VLB (the printed line).  The TPU
logs of the JAX package printed the same two numbers for seeds 0-4 of
both configs (`LOGS`).  On the card each seed's row also records the
process's peak memory and the VLB sweep's seconds.  A seed whose loss
lands within `GATE` of its log under the default setting (8 substeps) is
paired; else the other setting is tried once (1 step a dispatch), and if
it lands within `GATE` it is the seed's setting.  A seed that neither brings within `GATE` is unpaired.  (The
port draws with JAX's default `jax_threefry_partitionable` counter layout
only: the original layout, tried once for seed 0 in the first run, came
out 51% off its log; results/torch_f3_seeds/jaxrng/epoch0_gate_call1.log.)

At full width this runs on the card (the default device).  `--small` cuts
the model to 32^2 (base 32, mults 1 2) for a check on the CPU, where no
gate is read, and `--jax-side` then also trains each seed's epoch 0
through the JAX package in a subprocess (JAX_PLATFORMS=cpu; this script
imports no JAX) and records its loss and VLB beside the port's; `--set`
cuts that check further (say `Batch_Size=2 iters_per_epoch=8`: one
dispatch of 8 steps at batch 2, a CPU-minute instead of several).  The JSON
goes to --out (the config's gate file, `campaigns.band.EPOCH0_GATES`:
results/torch_jax_streams_epoch0.json for 256syn64s2d,
results/torch_jax_streams_epoch0_256syn128.json for 256syn128; with
--small the same name ending _cpu32.json); where the file exists, the rows
of the seeds run replace theirs and the others stay.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from anoddpm_torch.campaigns._results import save_results  # noqa: E402
from anoddpm_torch.campaigns.band import EPOCH0_GATES  # noqa: E402
from anoddpm_torch.campaigns.seed_replication import train_args_for  # noqa: E402
from anoddpm_torch.train import train  # noqa: E402

# the JAX package's epoch-0 loss and VLB of seed S of each config on the TPU
LOGS = {
    "256syn64s2d": {
        0: ("results/seed_replication.log:90", 0.15949, 7.2359),
        1: ("results/seed_replication.log:117", 0.16029, 7.4919),
        2: ("results/seed_replication.log:152", 0.15300, 7.3068),
        3: ("results/seed_replication_r3.log:25", 0.15479, 7.5361),
        4: ("results/seed_replication_r3.log:36", 0.15966, 6.9375),
    },
    "256syn128": {
        0: ("results/seed_replication.log:3", 0.12589, 6.7075),
        1: ("results/seed_replication.log:36", 0.13164, 7.6415),
        2: ("results/seed_replication.log:63", 0.11856, 7.8307),
        3: ("results/seed_replication_r3.log:3", 0.12518, 6.5405),
        4: ("results/seed_replication_r3.log:14", 0.12657, 6.9432),
    },
}
# relative distance of the port's epoch-0 loss from the log that pairs a seed
GATE = 0.02
# the settings tried in turn: the default, then the other once
SETTINGS = {
    "default": {},
    "substeps1": {"train_substeps": 1},
}
SMALL = {"img_size": [32, 32], "base_channels": 32, "channel_mults": "1,2",
         "attention_resolutions": "16", "T": 100, "sample_distance": 80}


def _epoch0(stdout: str, root: str, token: str):
    with open(os.path.join(root, "metrics", f"args{token}-train.jsonl")) as f:
        loss = json.loads(f.readline())["loss"]
    line = next(l for l in stdout.splitlines() if "total VLB" in l)
    return loss, float(line.split("total VLB: ")[1].split()[0]), line


def _sweep_seconds(line: str) -> float:
    return float(line.split("VLB sweep ")[1].split()[0])


def run_args(config: str, seed: int, setting: str, small: bool,
             cut=None):
    args = train_args_for(config, seed, ROOT, "jax_rng")
    args.update(SETTINGS[setting])
    if small:
        args.update(SMALL)
        args.update(cut or {})
    args["arg_num"] = f"{args['arg_num']}_e0_{setting}"
    args["skip_test_eval"] = True
    return args


def _fresh(root: str, token: str) -> None:
    """No metrics log of an earlier run under `root` (the logger appends)."""
    path = os.path.join(root, "metrics", f"args{token}-train.jsonl")
    if os.path.exists(path):
        os.remove(path)


def port_epoch0(args, root: str, device: str):
    _fresh(root, args["arg_num"])
    out = io.StringIO()
    on_card = str(device).startswith("cuda")
    if on_card:
        import torch
        torch.cuda.reset_peak_memory_stats()
    start = time.time()
    with contextlib.redirect_stdout(out):
        train(args, root_dir=root, max_epochs=0, device=device)
    loss, vlb, line = _epoch0(out.getvalue(), root, args["arg_num"])
    shutil.rmtree(os.path.join(root, "model"), ignore_errors=True)
    got = {"loss": loss, "vlb": vlb, "line": line,
           "seconds": time.time() - start,
           "vlb_sweep_seconds": _sweep_seconds(line)}
    if on_card:
        got["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    return got


def jax_epoch0(args, root: str):
    """The JAX package's trainer on the same args, in a subprocess."""
    jax_args = {k: v for k, v in args.items() if k not in ("rng",)}
    code = ("import json, sys; "
            "from anoddpm_tpu.config import defaultdict_from_json; "
            "from anoddpm_tpu.train import train; "
            "train(defaultdict_from_json(json.loads(sys.argv[1])), "
            "root_dir=sys.argv[2], max_epochs=0)")
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    _fresh(root, args["arg_num"])
    proc = subprocess.run([sys.executable, "-c", code, json.dumps(jax_args),
                           root], cwd=ROOT, env=env, capture_output=True,
                          text=True, check=True)
    loss, vlb, line = _epoch0(proc.stdout, root, args["arg_num"])
    shutil.rmtree(os.path.join(root, "model"), ignore_errors=True)
    return {"loss": loss, "vlb": vlb, "line": line}


def main(argv=None):
    p = argparse.ArgumentParser(prog="scripts/torch_jax_streams_epoch0.py")
    p.add_argument("--config", choices=sorted(LOGS), default="256syn64s2d")
    p.add_argument("--seeds", nargs="*", type=int, default=[0, 1, 2, 3, 4])
    p.add_argument("--device", default="cuda")
    p.add_argument("--small", action="store_true",
                   help="32^2, base 32: a check on the CPU, no gate")
    p.add_argument("--jax-side", action="store_true",
                   help="with --small: the JAX package's epoch 0 beside")
    p.add_argument("--set", nargs="*", default=[], metavar="KEY=VALUE",
                   help="with --small: integer config keys cut further")
    p.add_argument("--settings", nargs="*", default=list(SETTINGS),
                   choices=list(SETTINGS), help="the settings tried, in order")
    p.add_argument("--root", default=os.path.join(ROOT, "build", "epoch0"))
    p.add_argument("--out", default=None,
                   help="the config's gate file, or with --small its "
                        "name ending _cpu32.json")
    ns = p.parse_args(sys.argv[1:] if argv is None else argv)
    if (ns.jax_side or ns.set) and not ns.small:
        raise SystemExit("--jax-side and --set cut the CPU check: "
                         "only with --small")
    cut = {k: int(v) for k, v in (kv.split("=", 1) for kv in ns.set)}
    gate = EPOCH0_GATES[ns.config]
    out_path = ns.out or (gate[:-len(".json")] + "_cpu32.json" if ns.small
                          else gate)
    # a run of some seeds updates their rows of an existing file
    rows = {}
    if os.path.exists(os.path.join(ROOT, out_path)):
        with open(os.path.join(ROOT, out_path)) as f:
            rows = json.load(f)["seeds"]
    for seed in ns.seeds:
        where, log_loss, log_vlb = LOGS[ns.config][seed]
        row = ({"tried": {}} if ns.small else
               {"log": where, "log_loss": log_loss, "log_vlb": log_vlb,
                "tried": {}, "setting": None, "paired": False})
        for setting in ns.settings:
            args = run_args(ns.config, seed, setting, ns.small, cut)
            got = port_epoch0(args, os.path.join(ns.root, "port"), ns.device)
            row["tried"][setting] = got
            if ns.small:
                # a 32^2 model is not the logged one: the JAX package's run
                # of the same small config stands beside it instead
                if ns.jax_side:
                    got["jax_cpu"] = jax_epoch0(args, os.path.join(ns.root, "jax"))
                print(f"seed {seed} {setting} at 32^2: port loss "
                      f"{got['loss']:.5f}, VLB {got['vlb']:.4f}"
                      + (f"; JAX package loss {got['jax_cpu']['loss']:.5f}, "
                         f"VLB {got['jax_cpu']['vlb']:.4f}" if ns.jax_side
                         else ""), flush=True)
                continue
            got["loss_vs_log"] = got["loss"] / log_loss - 1.0
            got["vlb_vs_log"] = got["vlb"] / log_vlb - 1.0
            print(f"seed {seed} {setting}: loss {got['loss']:.5f} (log "
                  f"{log_loss}, {100 * got['loss_vs_log']:+.2f}%), VLB "
                  f"{got['vlb']:.4f} (log {log_vlb}, "
                  f"{100 * got['vlb_vs_log']:+.2f}%)", flush=True)
            if abs(got["loss_vs_log"]) <= GATE:
                row["setting"], row["paired"] = setting, True
                break
        rows[str(seed)] = row
    out = {"config": ns.config, "device": ns.device, "small": ns.small,
           **({"set": cut} if cut else {}),
           "gate": GATE, "settings": SETTINGS, "seeds": rows}
    if not ns.small:
        print("paired seeds:", sorted(int(s) for s, r in rows.items()
                                      if r["paired"]))
    save_results(ROOT, out_path, out)
    return out


if __name__ == "__main__":
    main()
