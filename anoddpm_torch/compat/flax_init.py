"""The JAX package's UNet initialisation, drawn in torch:
`jax_init_state_dict(args, seed)`; with the same key derivation, the
keys of flax's dropout masks in a train step (`dropout_keys`) and flax's
init of the context encoder (`jax_context_encoder_state_dict`).

The JAX trainer initialises its UNet with `model.init(init_key, x, t)`,
`init_key` the second half of `jax.random.split(jax.random.key(seed))`
(`anoddpm_tpu/train.py:54-58`).  flax derives every parameter's key from
that one key without splitting it (flax 0.12.3, `flax/core/scope.py`):
each module scope carries the init key with the names of its path as a
lazy suffix (`Scope.push`, :600-638, `LazyRng.create`, :96-103); each
`param` call draws `make_rng("params")` (:736-746), which appends the
scope's running count of such calls (1 for a layer's first parameter)
and folds the SHA-1 of the whole suffix into the key once
(`_fold_in_static`, :110-134: the first four bytes of the digest of the
names' UTF-8 and the counts' big-endian bytes, with no separator as
`flax_fix_rng_separator` is off by default).

The JAX UNet's initialisers are flax's defaults and constants
(`anoddpm_tpu/models/unet.py`): a conv or dense kernel is `lecun_normal`
(`jax.nn.initializers.variance_scaling(1, "fan_in",
"truncated_normal")`: a normal truncated at +-2, times sqrt(1 / fan_in) /
.87962566103423978 in fp32), or zeros where the layer is zero-initialised
(a ResBlock's conv_out, attention's proj, out_conv); biases are zeros and
norm scales ones.  A kernel is its layer's first parameter, so its key is
`fold_in(init_key, sha1(path, 1))`.  The port's `UNet` names its layers
after the flax tree (`flax_params.unet_state_dict_from_flax` maps one onto
the other), so a layer's flax path is its module name split at the dots,
and its flax kernel is the port's weight transposed back to (kh, kw, I, O)
or (I, O).  No flax or jax is imported.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence

import torch

from .. import streams
from ..config import resolve_in_channels
from ..models.unet import Conv, Dense, GroupNorm32, ResBlock, unet_from_args
from . import jax_random as jr
from .jax_random import fold_in_static

# the standard deviation of a unit normal truncated at +-2
_TRUNC_STD = 0.87962566103423978


def init_key(seed: int) -> jr.JaxKey:
    """The key the JAX trainer hands `model.init`: `split(key(seed))[1]`."""
    return jr.key(seed).split()[1]


def lecun_normal(k: jr.JaxKey, shape: Sequence[int]) -> torch.Tensor:
    """`jax.nn.initializers.lecun_normal()(k, shape, float32)` on k.device:
    fan_in is every axis but the last (`_compute_fans`), the scale
    sqrt(fp32(1 / fan_in)) / fp32(.8796...) rounded as XLA rounds it."""
    fan_in = math.prod(shape[:-1])
    variance = torch.tensor(1.0 / fan_in, dtype=torch.float32, device=k.device)
    stddev = torch.sqrt(variance) / torch.tensor(_TRUNC_STD, dtype=torch.float32,
                                                 device=k.device)
    return jr.truncated_normal(k, -2.0, 2.0, shape) * stddev


def jax_init_state_dict(args, seed: int, device=None) -> Dict[str, torch.Tensor]:
    """The port UNet's `state_dict` (fp32, on `device`, the CPU by default)
    holding the parameters that the JAX package's `model.init` gives its
    UNet for `args` under `split(key(seed))[1]`."""
    with torch.device("meta"):
        model = unet_from_args(args, resolve_in_channels(args))
    root = init_key(seed).on(device)
    out: Dict[str, torch.Tensor] = {}
    for name, module in model.named_modules():
        if isinstance(module, (Conv, Dense)):
            w = module.weight
            if module.zero:
                value = torch.zeros(w.shape, device=root.device)
            else:
                if w.dim() == 4:    # (O, I, kh, kw) <- flax (kh, kw, I, O)
                    flax_shape, back = (*w.shape[2:], w.shape[1], w.shape[0]), (3, 2, 0, 1)
                else:               # (O, I) <- flax (I, O)
                    flax_shape, back = (w.shape[1], w.shape[0]), (1, 0)
                k = fold_in_static(root, tuple(name.split(".")) + (1,))
                value = lecun_normal(k, flax_shape).permute(*back).contiguous()
            out[f"{name}.weight"] = value
            out[f"{name}.bias"] = torch.zeros(module.bias.shape, device=root.device)
        elif isinstance(module, GroupNorm32):
            out[f"{name}.weight"] = torch.ones(module.weight.shape, device=root.device)
            out[f"{name}.bias"] = torch.zeros(module.bias.shape, device=root.device)
    missing = sorted(set(model.state_dict()) - set(out))
    if missing:
        raise KeyError(f"no JAX initialiser for {missing[:3]}")
    return out


def dropout_keys(model, drop_key: streams.Stream) -> Dict[str, streams.Stream]:
    """The key of flax's `make_rng("dropout")` in each ResBlock's
    `nn.Dropout` (`anoddpm_tpu/models/unet.py:133`) when the JAX step
    applies the UNet with `rngs={"dropout": drop_key}`
    (`anoddpm_tpu/training.py:84-97`), by the port's block name: the
    block's scope pushes its path, the unnamed Dropout its auto-name
    "Dropout_0", and its one draw counts 1, so the key is drop_key with
    (path, "Dropout_0", 1) folded in statically.  A torch.Generator
    passes as itself."""
    return {name: streams.of(drop_key).fold_in_static(
                (*name.split("."), "Dropout_0", 1))
            for name, module in model.named_modules()
            if isinstance(module, ResBlock) and module.dropout > 0}


def jax_context_encoder_state_dict(model,
                                   seed: int) -> Dict[str, torch.Tensor]:
    """The `state_dict` of the port's `ContextEncoder` `model` holding what
    flax's init of the JAX package's gives under `key(seed)`
    (`anoddpm_tpu/baselines.py:40-42`): each `Conv_i` kernel lecun_normal
    at `fold_in_static(key(seed), ("Conv_i", 1))`, the biases zeros, the
    GroupNorm scales ones, on the CPU."""
    root = jr.key(seed)
    out = {}
    for name, value in model.state_dict().items():
        module, index, leaf = name.split(".")
        if module == "convs" and leaf == "weight":
            o, i, kh, kw = value.shape
            k = fold_in_static(root, (f"Conv_{index}", 1))
            value = lecun_normal(k, (kh, kw, i, o)).permute(3, 2, 0, 1)
        elif module == "norms" and leaf == "weight":
            value = torch.ones(value.shape)
        else:
            value = torch.zeros(value.shape)
        out[name] = value.contiguous()
    return out
