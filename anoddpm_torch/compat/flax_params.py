"""Convert the JAX package's UNet parameters into the port's `state_dict`.

The port's UNet names its submodules after the flax tree, so the conversion
is a walk over the nested dict of numpy arrays:

- conv kernels (kh, kw, I, O) become weights (O, I, kh, kw);
- dense kernels (I, O) become weights (O, I);
- `GroupNorm_0/{scale, bias}` become the norm's `weight` / `bias`;
- the fused-norm names `{name}_pscale` / `{name}_pbias`
  (`pallas_norm: true` in the JAX package) map onto the same norm weights;
- the UNet options `biggan_updown=False` (`down_sample_i` / `up_sample_i`
  are convs) and `use_conv_skip` (a 3 x 3 `skip` kernel) need nothing
  more: their kernels walk like any other.

`context_encoder_state_dict_from_flax` converts the context encoder's
auto-named `Conv_i` / `GroupNorm_i` into the port's `convs.i` / `norms.i`.

The optimizer state carried across: the optax chain of the JAX trainer
(clip_by_global_norm, then adamw) keeps Adam's `count`, `mu` and `nu`,
the last two trees shaped like the parameters.  `adamw_state_from_optax`
converts them by the same walk into `torch.optim.AdamW`'s per-parameter
`step`, `exp_avg` and `exp_avg_sq`, keyed by parameter name.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

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


def context_encoder_state_dict_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """Port `state_dict` of `models.context_encoder.ContextEncoder` from the
    flax `ContextEncoder`'s params."""
    if "params" in params:
        params = params["params"]
    renamed = {}
    for name, leaves in params.items():
        kind, _, index = name.rpartition("_")
        prefix = {"Conv": "convs", "GroupNorm": "norms"}.get(kind)
        if prefix is None:
            raise KeyError(f"unexpected flax module {name}")
        renamed[f"{prefix}.{index}"] = ({"GroupNorm_0": leaves}
                                         if kind == "GroupNorm" else leaves)
    return unet_state_dict_from_flax(renamed)


def _find_adam_state(tree: Any):
    """The {"count", "mu", "nu"} node of an optax state tree, or None."""
    if not isinstance(tree, Mapping):
        return None
    if {"count", "mu", "nu"} <= set(tree):
        return tree
    for value in tree.values():
        found = _find_adam_state(value)
        if found is not None:
            return found
    return None


def is_optax_state(tree: Any) -> bool:
    return _find_adam_state(tree) is not None


def adamw_state_from_optax(opt_state: Mapping) -> Dict[str, Dict[str, torch.Tensor]]:
    """AdamW state by parameter name, {name: {"step", "exp_avg",
    "exp_avg_sq"}}, from the optax chain state of the JAX trainer as a
    nested dict (`flax.serialization.to_state_dict`, or a checkpoint's
    "opt" read with plain msgpack)."""
    adam = _find_adam_state(opt_state)
    if adam is None:
        raise KeyError("no optax Adam state (count, mu, nu) in the tree")
    step = torch.tensor(float(np.asarray(adam["count"])), dtype=torch.float32)
    exp_avg = unet_state_dict_from_flax(adam["mu"])
    exp_avg_sq = unet_state_dict_from_flax(adam["nu"])
    return {name: {"step": step.clone(), "exp_avg": exp_avg[name],
                   "exp_avg_sq": exp_avg_sq[name]} for name in exp_avg}
