"""The UNet's weights, made from the seed on the device in one draw.

One `torch.randn` of every parameter's elements from a `torch.Generator`
on the device, then each parameter a view of it, scaled: LeCun's
1/sqrt(fan_in) for the convolutions' and dense layers' kernels (the output
convolutions too, which the published init zeroes: with them at zero the
UNet's eps would be 0 and hide every fault upstream), 0.02 for their
biases, 1 + 0.1 n and 0.1 n for the norms' scales and shifts.  No
parameter is zero.  fp32, the type the port keeps its parameters in.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from ..reference import unet as ru
from .seeds import sub_seed


def make(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """{name: fp32 tensor} with the port's (and the reference's) names."""
    with torch.device("meta"):
        model = ru.unet_of(cfg)
    specs = []
    for mod_name, mod in model.named_modules():
        for p_name, p in mod.named_parameters(recurse=False):
            name = f"{mod_name}.{p_name}" if mod_name else p_name
            if isinstance(mod, ru.Norm):
                scale, shift = 0.1, 1.0 if p_name == "weight" else 0.0
            elif p_name == "bias":
                scale, shift = 0.02, 0.0
            else:
                scale, shift = 1.0 / math.sqrt(p[0].numel()), 0.0
            specs.append((name, tuple(p.shape), scale, shift))
    total = sum(math.prod(s) for _, s, _, _ in specs)
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, "weights"))
    flat = torch.randn((total,), generator=gen, device=device)
    out, at = {}, 0
    for name, shape, scale, shift in specs:
        n = math.prod(shape)
        out[name] = flat[at:at + n].view(shape).mul_(scale).add_(shift)
        at += n
    return out
