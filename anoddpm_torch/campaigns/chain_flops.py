"""FLOPs of the reverse chains and their 100%-MFU ceilings on the card:
``python -m anoddpm_torch.campaigns.chain_flops [--root DIR]``.

Counterpart of `scripts/chain_flops.py`: the UNet forward's FLOPs per image
(`bench.unet_fwd_flops`, `FlopCounterMode`: convolutions and matmuls) for
the paper config at batch 8 and the headline (base 64, s2d 2) at batch 32;
from them the TFLOP of one slice's DDPM-250, DDPM-200 and DDIM-15 chain,
and the most slices per second the card could score if every one of those
FLOPs ran at the H100's bf16 dense peak (`bench.PEAK_TFLOPS_BF16`).
Writes ``results/torch_chain_flops.json`` under DIR and prints it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from ..bench import PEAK_SOURCE, PEAK_TFLOPS_BF16, card_info, unet_fwd_flops
from ..device import DeviceLike, resolve_device

RESULTS = "results/torch_chain_flops.json"
ROWS = {"paper_b8": (8, 128, 1),           # args28's architecture, batch 8
        "headline_b32_s2d": (32, 64, 2)}   # bench.py's headline
CHAINS = ((250, "ddpm250"), (200, "ddpm200"), (15, "ddim15"))


def run(root_dir: str = ".", device: DeviceLike = None, rows=ROWS,
        img: int = 256):
    device = resolve_device(device)
    out = {"peak_tflops_bf16": PEAK_TFLOPS_BF16, "peak_source": PEAK_SOURCE,
           "counter": "torch.utils.flop_counter.FlopCounterMode over one "
                      "UNet forward (convolutions and matmuls)",
           **card_info(device)}
    for name, (batch, base, s2d) in rows.items():
        per_img = unet_fwd_flops(batch, base, s2d, img, device=device) / batch
        row = {"batch": batch, "base_channels": base, "s2d": s2d,
               "fwd_flops_per_img": per_img,
               "fwd_tflop_per_img": per_img / 1e12}
        for steps, label in CHAINS:
            chain = per_img * steps
            row[f"{label}_tflop_per_slice"] = chain / 1e12
            row[f"{label}_max_slices_per_sec_100mfu"] = (
                PEAK_TFLOPS_BF16 * 1e12 / chain)
        out[name] = row
    path = os.path.join(root_dir, RESULTS)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out, indent=1), flush=True)
    return out


def main(argv=None, device: DeviceLike = None):
    p = argparse.ArgumentParser(prog="python -m anoddpm_torch.campaigns.chain_flops")
    p.add_argument("--root", default=".")
    ns = p.parse_args(sys.argv[1:] if argv is None else argv)
    return run(ns.root, device)


if __name__ == "__main__":
    main()
