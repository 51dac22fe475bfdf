"""Detection quality across trained models and samplers:
``python -m anoddpm_torch.campaigns.model_size_quality <token> [<token>...]
[--root DIR] [--out NAME]``.

Counterpart of `scripts/model_size_quality.py`: each token under DDPM-200,
DDIM-25 and DDIM-15 at eta = 1; AUC, Dice, SSIM and IoU per
``{token}/{protocol}``, printed after each and written to NAME under DIR
(metrics/torch_model_size_quality.json by default) beside the entries of
other tokens that the file already holds.

The JAX package's file of this campaign, ``results/model_size_quality.json``,
scores tokens that its train CLI trained to their configs' own recipe
(`RECIPE`, as ``scripts/torch_model_size_jax_code.py`` found it in the
JAX code that wrote the file: ``results/torch_model_size_jax_code.json``).
``--write-config CONFIG`` writes ``configs/args{CONFIG}_jaxrng.json`` under
DIR: that recipe on the JAX package's random streams (`rng: "jax"`, seed
0), which the train CLI trains as the token ``{CONFIG}_jaxrng``.
``--paired [--config C]`` holds such a token's scores (``results/torch_
model_size_jaxrng.json``) against the JAX file's rows of the same config
by `paired_verdict` (the rule of PERF.md section 2) and writes
``results/torch_model_size_jaxrng_paired.json`` (for 256syn64; the
control 256syn128 ``..._paired_256syn128.json``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Any, Dict, Mapping, Optional, Sequence

import numpy as np

from ..config import load_args
from ..detect import _load_eval_model, anomalous_metric_calculation
from ..device import DeviceLike
from ._results import load_results, save_results

PROTOCOLS = [
    ("ddpm200", {"sampler": "ddpm"}),
    ("ddim25_eta1", {"sampler": "ddim", "ddim_steps": 25, "ddim_eta": 1.0}),
    ("ddim15_eta1", {"sampler": "ddim", "ddim_steps": 15, "ddim_eta": 1.0}),
]
SHOWN = ("auc", "dice", "ssim", "iou")
OUT = "metrics/torch_model_size_quality.json"

# The round-1 tokens' recipe: the config's own keys as the JAX train CLI
# reads them (no `train_substeps`: 1 step a dispatch; `dropout` 0; the
# trainer's EMA 0.9999; bf16 activations) and flax's norm order, GroupNorm
# in fp32 cast to bf16 before SiLU, which is the port's "flax" order with
# `bf16_norm` and `pallas_norm` off.  The test-set suite after training
# reads the final weights and changes none, so the card skips it.
RECIPE = {"train_substeps": 1, "dropout": 0, "ema_decay": 0.9999,
          "compute_dtype": "bfloat16", "norm_impl": "flax",
          "bf16_norm": False, "pallas_norm": False}
JAX_STREAMS = {"rng": "jax", "seed": 0, "skip_test_eval": True}
JAX_FILE = "results/model_size_quality.json"
CODE_FILE = "results/torch_model_size_jax_code.json"
PORT_FILE = "results/torch_model_size_jaxrng.json"
PAIRED_FILE = "results/torch_model_size_jaxrng_paired.json"
JAX_SEEDS = "results/seed_replication.json"
# the JAX band whose five seeds give sigma_JAX, and the port's paired seeds
SIGMA_CELL = "paper128_ddpm200"
PORT_PAPER_SEEDS = "results/torch_jax_rng_256syn128_seeds0.json"
PAIRED_METRICS = ("auc", "dice")
P1 = "ddpm200"


def token_of(config: str) -> str:
    return f"{config}_jaxrng"


def model_args(config: str = "256syn64", root_dir: str = "."):
    """configs/args{config}.json under `root_dir` in its own recipe on the
    JAX streams, under the token {config}_jaxrng."""
    args = load_args(config, config_dir=os.path.join(root_dir, "configs"))
    args.update(RECIPE)
    args.update(JAX_STREAMS)
    args["arg_num"] = token_of(config)
    return args


def write_config(config: str = "256syn64", root_dir: str = ".") -> str:
    """configs/args{config}_jaxrng.json under `root_dir` (what the train
    CLI reads for the token); its path."""
    config_dir = os.path.join(root_dir, "configs")
    with open(os.path.join(config_dir, f"args{config}.json")) as f:
        raw = json.load(f)
    path = os.path.join(config_dir, f"args{token_of(config)}.json")
    with open(path, "w") as f:
        json.dump({**raw, **RECIPE, **JAX_STREAMS}, f, indent=1)
    return path


def run(tokens: Sequence[str], root_dir: str = ".",
        device: DeviceLike = None, out: str = OUT) -> Dict[str, Dict[str, float]]:
    results = {}
    for token in tokens:
        args, em, sched = _load_eval_model(root_dir, token, device=device)
        for name, overrides in PROTOCOLS:
            args.update(overrides)
            r = anomalous_metric_calculation(args=args, root_dir=root_dir,
                                             em=em, sched=sched, device=device)
            results[f"{token}/{name}"] = {m: round(r[m], 4) for m in SHOWN}
            print(json.dumps(results, indent=1), flush=True)
    # the entries of other tokens already in the file stay
    merged = {**load_results(root_dir, out), **results}
    save_results(root_dir, out, merged)
    return merged


def jax_sigma(root_dir: str = ".") -> Dict[str, float]:
    """The five-seed sample std (ddof 1) of SIGMA_CELL in the JAX seeds'
    file, per paired metric."""
    res = load_results(root_dir, JAX_SEEDS)
    seeds = [k for k in res if k.startswith(f"{SIGMA_CELL}/seed")]
    return {m: float(np.std([res[k][m] for k in seeds], ddof=1))
            for m in PAIRED_METRICS}


def paired_verdict(port: Mapping[str, Mapping[str, float]],
                   jax: Mapping[str, Mapping[str, float]],
                   sigma: Mapping[str, float],
                   code_parts_at: Optional[str] = None) -> Dict[str, Any]:
    """The rule written before the card run (PERF.md section 2), on the
    six pairs {protocol: {auc, dice}} of each side.  Delta = port - JAX.
    "open: the round-1 code is not today's" (naming where the trees part)
    when `code_parts_at` is set; else "a fault in the port" (naming the
    pairs) when any |Delta| > 2 sigma; else "closed: the model size pairs"
    when P1's (DDPM-200's) |Delta| <= sigma / 2 in both metrics and all
    six |Delta| <= sigma; else "open: the trajectories part"."""
    delta = {p: {m: port[p][m] - jax[p][m] for m in PAIRED_METRICS}
             for p, _ in PROTOCOLS}
    over = lambda k: [f"{p}, {m}" for p in delta for m in PAIRED_METRICS
                      if abs(delta[p][m]) > k * sigma[m]]
    out: Dict[str, Any] = {"delta": delta, "sigma_jax": dict(sigma)}
    if code_parts_at:
        out["verdict"] = ("open: the round-1 code is not today's (the trees "
                          f"part at {code_parts_at})")
    elif over(2):
        out["verdict"] = "a fault in the port: " + "; ".join(over(2))
    elif all(abs(delta[P1][m]) <= sigma[m] / 2 for m in PAIRED_METRICS) \
            and not over(1):
        out["verdict"] = "closed: the model size pairs"
    else:
        out["verdict"] = "open: the trajectories part"
    return out


def paired_file(config: str) -> str:
    """The paired file of `config`'s token: PAIRED_FILE for the model-size
    token, one named after the config for the control."""
    return (PAIRED_FILE if config == "256syn64"
            else PAIRED_FILE.replace(".json", f"_{config}.json"))


def paired_main(root_dir: str = ".", config: str = "256syn64",
                port_file: str = PORT_FILE, out: Optional[str] = None
                ) -> Dict[str, Any]:
    """The port's token of `config` against the JAX file's rows; writes
    `out` (`paired_file(config)`) under `root_dir`.  Beside the model-size
    token's, not held: the model-size difference at DDPM-200 (256syn64 -
    256syn128) in the JAX file and in the port (its 256syn128 the control
    token where `port_file` holds it, else seed 0 of the paper's band on
    the JAX streams)."""
    jax_all = load_results(root_dir, JAX_FILE)
    port_all = load_results(root_dir, port_file)
    token = token_of(config)
    jax = {p: jax_all[f"{config}/{p}"] for p, _ in PROTOCOLS}
    port = {p: port_all[f"{token}/{p}"] for p, _ in PROTOCOLS}
    code = load_results(root_dir, CODE_FILE)
    parted = [f"{t}: {c['first_parting']}"
              for t, c in code.get("against", {}).items() if c["first_parting"]]
    res = paired_verdict(port, jax, jax_sigma(root_dir),
                         "; ".join(parted) or None)
    control = f"{token_of('256syn128')}/{P1}"
    if config != "256syn128":
        if control in port_all:
            port128, label = port_all[control], control
        else:
            port128 = load_results(root_dir, PORT_PAPER_SEEDS)[
                f"{SIGMA_CELL}/seed0"]
            label = f"{SIGMA_CELL}/seed0 ({PORT_PAPER_SEEDS})"
        res["model_size_difference"] = {
            "jax": {m: jax[P1][m] - jax_all[f"256syn128/{P1}"][m]
                    for m in PAIRED_METRICS},
            "port": {m: port[P1][m] - port128[m] for m in PAIRED_METRICS},
            "port_256syn128": label}
    res.update(config=config, port=port, jax=jax, jax_file=JAX_FILE,
               port_file=port_file, code_file=CODE_FILE,
               code_verdict=code.get("verdict"))
    save_results(root_dir, out or paired_file(config), res)
    return res


def _print_paired(res: Mapping[str, Any]) -> None:
    for p, d in res["delta"].items():
        print(f"{p}: " + ", ".join(
            f"{m} port {res['port'][p][m]:.4f} JAX {res['jax'][p][m]:.4f} "
            f"delta {d[m]:+.4f} ({d[m] / res['sigma_jax'][m]:+.2f} sigma)"
            for m in PAIRED_METRICS))
    diff = res.get("model_size_difference")
    if diff:
        print("model-size difference at DDPM-200 (not held): " + "; ".join(
            f"{side} " + ", ".join(f"{m} {v:+.4f}" for m, v in diff[side].items())
            for side in ("jax", "port"))
            + f" (port 256syn128: {diff['port_256syn128']})")
    print("verdict:", res["verdict"])


def main(argv=None, device: DeviceLike = None):
    p = argparse.ArgumentParser(
        prog="python -m anoddpm_torch.campaigns.model_size_quality")
    p.add_argument("tokens", nargs="*")
    p.add_argument("--root", default=".")
    p.add_argument("--out", default=OUT, help="the scores' file under --root")
    p.add_argument("--write-config", metavar="CONFIG", default=None,
                   help="write configs/args{CONFIG}_jaxrng.json under --root")
    p.add_argument("--paired", action="store_true",
                   help="hold the JAX-stream token against the JAX file")
    p.add_argument("--config", default="256syn64",
                   help="with --paired: the config whose token is held "
                        "(256syn128: the control)")
    ns = p.parse_args(sys.argv[1:] if argv is None else argv)
    if ns.write_config:
        print(write_config(ns.write_config, ns.root))
        return None
    if ns.paired:
        res = paired_main(ns.root, ns.config)
        _print_paired(res)
        return res
    if not ns.tokens:
        p.error("name a token, --write-config or --paired")
    return run(ns.tokens, ns.root, device, ns.out)


if __name__ == "__main__":
    main()
