"""One train-MFU probe on the card:
``python -m anoddpm_torch.campaigns.mfu_push <batch> [bf16_norm=1]
[base=128] [s2d=1] [remat=none|dots|nothing] [unroll=1] [pallas_norm=0]
[norm_impl=kernel] [--root DIR]``.

Counterpart of `scripts/mfu_push.py`, with its positional arguments and
one more, the port's `norm_impl` ("kernel": K2 and K2b at every site, where
`bf16_norm` and `pallas_norm` change nothing; "flax": the JAX package's
composition).  It times `training.make_multi_step` at 8 substeps on
256^2 images (`bench.train_probe`: 8 eager steps per call, the median of
5 calls after a warm-up) and counts one step's FLOPs at the same remat
policy, so that recompute counts toward the MFU numerator while images/s
stays the end metric.  `unroll` other than 1 raises: the port takes its
substeps in a Python loop, with no scan to unroll.  Appends one JSON line
to ``results/torch_mfu_push.jsonl`` under DIR and prints it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from ..bench import PEAK_TFLOPS_BF16, card_info, train_probe
from ..device import DeviceLike, resolve_device

RESULTS = "results/torch_mfu_push.jsonl"
SUBSTEPS = 8
IMG = 256


def parse(argv):
    p = argparse.ArgumentParser(prog="python -m anoddpm_torch.campaigns.mfu_push")
    p.add_argument("batch", nargs="?", type=int, default=8)
    p.add_argument("bf16_norm", nargs="?", type=int, default=1)
    p.add_argument("base", nargs="?", type=int, default=128)
    p.add_argument("s2d", nargs="?", type=int, default=1)
    p.add_argument("remat", nargs="?", default="none")
    p.add_argument("unroll", nargs="?", type=int, default=1)
    p.add_argument("pallas_norm", nargs="?", type=int, default=0)
    p.add_argument("norm_impl", nargs="?", default="kernel")
    p.add_argument("--root", default=".")
    ns = p.parse_args(argv)
    if ns.unroll != 1:
        raise ValueError(f"unroll={ns.unroll}: the port takes its substeps in "
                         "a Python loop and has no scan to unroll")
    return ns


def main(argv=None, device: DeviceLike = None, img: int = IMG,
         substeps: int = SUBSTEPS, repeats: int = 5):
    ns = parse(sys.argv[1:] if argv is None else argv)
    device = resolve_device(device)
    norm = dict(norm_impl=ns.norm_impl, bf16_norm=bool(ns.bf16_norm),
                pallas_norm=bool(ns.pallas_norm))
    remat = None if ns.remat == "none" else ns.remat
    probe = train_probe(ns.batch, img, ns.base, substeps, repeats, ns.s2d,
                        remat=remat, norm=norm, device=device)
    row = {"batch": ns.batch, "bf16_norm": bool(ns.bf16_norm), "base": ns.base,
           "s2d": ns.s2d, "remat": probe["remat"], "unroll": ns.unroll,
           "pallas_norm": bool(ns.pallas_norm), "norm_impl": ns.norm_impl,
           "img": img, "substeps": substeps,
           "ms_per_step": probe["ms_per_step"],
           "imgs_per_sec": probe["imgs_per_sec"],
           "tflop_per_step": probe["tflop_per_step"], "mfu": probe["mfu"],
           "peak_memory_gib": probe["peak_memory_gib"],
           "peak_tflops_bf16": PEAK_TFLOPS_BF16, **card_info(device)}
    path = os.path.join(ns.root, RESULTS)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "a") as f:
        f.write(json.dumps(row) + "\n")
    print(json.dumps(row), flush=True)
    return row


if __name__ == "__main__":
    main()
