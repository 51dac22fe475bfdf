"""Experiment configuration: numbered JSON args files.

Own copy of the contract in `anoddpm_tpu/config.py`: experiments are
``configs/args{N}.json`` files, any key not present resolves to ``""``
(defaultdict-str semantics), and the experiment number is injected as
``args["arg_num"]``.  The CLI accepts ``28``, ``args28`` or ``args28.json``.
"""

from __future__ import annotations

import json
import os
from collections import defaultdict
from typing import Any, Dict

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


def load_args(token: str, config_dir: str = "configs") -> "defaultdict[str, Any]":
    """Load args{N}.json by experiment token, injecting arg_num and defaults."""
    arg_num = normalise_arg_token(str(token))
    path = os.path.join(config_dir, f"args{arg_num}.json")
    with open(path, "r") as f:
        raw = json.load(f)
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
