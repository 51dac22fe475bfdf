"""Convert the JAX package's UNet parameters into the port's `state_dict`.

The port's UNet names its submodules after the flax tree, so the conversion
is a walk over the nested dict of numpy arrays:

- conv kernels (kh, kw, I, O) become weights (O, I, kh, kw);
- dense kernels (I, O) become weights (O, I);
- `GroupNorm_0/{scale, bias}` become the norm's `weight` / `bias`;
- the fused-norm names `{name}_pscale` / `{name}_pbias`
  (`pallas_norm: true` in the JAX package) map onto the same norm weights.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def _walk(tree: Mapping, prefix: tuple):
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _walk(value, prefix + (key,))
        else:
            yield prefix + (key,), np.asarray(value)


def unet_state_dict_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """Port `state_dict` from flax UNet params (with or without the
    top-level "params" collection)."""
    if "params" in params:
        params = params["params"]
    out: Dict[str, torch.Tensor] = {}
    for path, value in _walk(params, ()):
        *mods, leaf = path
        if mods and mods[-1] == "GroupNorm_0":
            mods = mods[:-1]
            leaf = {"scale": "weight", "bias": "bias"}[leaf]
        elif leaf.endswith("_pscale") or leaf.endswith("_pbias"):
            name, kind = leaf.rsplit("_", 1)
            mods = mods + [name]
            leaf = "weight" if kind == "pscale" else "bias"
        elif leaf == "kernel":
            leaf = "weight"
            value = (value.transpose(3, 2, 0, 1) if value.ndim == 4
                     else value.T)
        elif leaf != "bias":
            raise KeyError(f"unexpected flax parameter {'/'.join(path)}")
        key = ".".join(mods + [leaf])
        if key in out:
            raise KeyError(f"two flax parameters map onto {key}")
        out[key] = torch.from_numpy(np.array(value, np.float32))
    return out
