"""Experiment configuration: numbered JSON args files.

Own copy of the contract in `anoddpm_tpu/config.py`: experiments are
``configs/args{N}.json`` files, any key not present resolves to ``""``
(defaultdict-str semantics), and the experiment number is injected as
``args["arg_num"]``.  The CLI accepts ``28``, ``args28`` or ``args28.json``.
Because a missing key resolves to ``""``, `load_args` warns on every key
outside `KNOWN_KEYS`: a misspelled key would otherwise change behaviour
without a sign.
"""

from __future__ import annotations

import json
import os
import warnings
from collections import defaultdict
from typing import Any, Dict, List

# The keys of the reference's configs and the JAX package's extensions
# (the set of `anoddpm_tpu/config.py:KNOWN_KEYS`), and the port's own.
KNOWN_KEYS = {
    "img_size", "Batch_Size", "EPOCHS", "T", "base_channels", "beta_schedule",
    "channel_mults", "loss-type", "loss_weight", "train_start", "lr",
    "random_slice", "sample_distance", "weight_decay", "save_imgs",
    "save_vids", "dropout", "attention_resolutions", "num_heads",
    "num_head_channels", "noise_fn", "dataset", "channels", "arg_num",
    "compute_dtype", "seed", "mesh", "num_res_blocks", "iters_per_epoch",
    "simplex_octaves", "simplex_persistence", "simplex_frequency",
    "simplex_table",
    "checkpoint_every", "ema_decay", "grad_clip_norm",
    "train_substeps", "sampler", "ddim_steps", "ddim_eta", "space_to_depth",
    "bf16_norm", "lesion_kind", "lesion_severity", "recon_repeats",
    "anomalous_volumes",
    # the port's own: which norms the UNet runs, kernel K2 ("kernel") or the
    # JAX package's composition ("flax"; models/unet.py)
    "norm_impl",
    # the port's own: which random streams a run draws from, torch's
    # ("torch", the default) or the JAX package's threefry keys ("jax";
    # streams.py, compat/jax_random.py)
    "rng",
    "_note",  # free-form provenance comment in shipped configs
}

DEFAULTS: Dict[str, Any] = {
    "compute_dtype": "bfloat16",
    "seed": 0,
    "ema_decay": 0.9999,
    "grad_clip_norm": 1.0,
    "simplex_octaves": 6,
    "simplex_persistence": 0.8,
    "simplex_frequency": 64,
    "checkpoint_every": 1000,
}


def defaultdict_from_json(json_dict: Dict[str, Any]) -> "defaultdict[str, Any]":
    """Missing keys resolve to "" (the reference's helpers.py:19-23)."""
    dd: "defaultdict[str, Any]" = defaultdict(str)
    dd.update(json_dict)
    return dd


def normalise_arg_token(token: str) -> str:
    """'28' | 'args28' | 'args28.json' -> '28'."""
    if token.endswith(".json"):
        token = token[:-5]
    if token.startswith("args"):
        token = token[4:]
    return token


def validate_args(raw: Dict[str, Any], source: str = "") -> List[str]:
    """Warn once per key of `raw` that no component reads, and return those
    keys sorted.  The keys still pass through untouched."""
    unknown = sorted(k for k in raw if k not in KNOWN_KEYS)
    where = f" in {source}" if source else ""
    for k in unknown:
        warnings.warn(f"unknown config key {k!r}{where}: no component reads "
                      "it (missing keys default to \"\")", stacklevel=2)
    return unknown


def load_args(token: str, config_dir: str = "configs") -> "defaultdict[str, Any]":
    """Load args{N}.json by experiment token, injecting arg_num and defaults."""
    arg_num = normalise_arg_token(str(token))
    path = os.path.join(config_dir, f"args{arg_num}.json")
    with open(path, "r") as f:
        raw = json.load(f)
    validate_args(raw, source=path)
    args = defaultdict_from_json(raw)
    args["arg_num"] = arg_num
    for k, v in DEFAULTS.items():
        if k not in raw:
            args[k] = v
    # img_size is a [H, W] list in JSON; keep as tuple internally.
    if args["img_size"] != "":
        args["img_size"] = tuple(args["img_size"])
    return args


def resolve_in_channels(args: Dict[str, Any]) -> int:
    """Channel count by dataset (reference diffusion_training.py:33-37)."""
    in_channels = 1
    ds = str(args.get("dataset", "")).lower()
    if ds in ("cifar", "leather"):
        in_channels = 3
    if args.get("channels", "") != "":
        in_channels = int(args["channels"])
    return in_channels
