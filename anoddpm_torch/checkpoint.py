"""Checkpoint save/load in the JAX package's layout, where args travel
inside the checkpoint:

    model/diff-params-ARGS={n}/params-final/                  final save
    model/diff-params-ARGS={n}/checkpoint/diff_epoch={e}/     periodic saves

Each directory holds `payload.msgpack` ({"model", "ema", "opt"}) and
`meta.json` ({"n_epoch", "args", "loss"}).

The payload is read with plain `msgpack`: arrays are flax's extension type
1, a packed (shape, dtype name, bytes) triple.  A payload written by the JAX
package holds flax parameter trees and the optax chain state, which are
converted on load to the port's `state_dict`s and AdamW state
(`compat.flax_params`).  One written by the port holds `state_dict`s as
flat {name: array} maps and AdamW's state as {name: {"step", "exp_avg",
"exp_avg_sq"}}, in the same encoding.  RESUME_RECENT reads the newest
periodic checkpoint that reads cleanly; the final save purges them.
"""

from __future__ import annotations

import json
import os
import re
import shutil
from typing import Any, Dict, List, Mapping, Optional, Tuple

import msgpack
import numpy as np
import torch

from .compat.flax_params import (adamw_state_from_optax, is_optax_state,
                                 unet_state_dict_from_flax)
from .config import defaultdict_from_json, normalise_arg_token

_EXT_NDARRAY = 1   # flax serialization's ext codes
_EXT_NPSCALAR = 3


def _unpack_array(data: bytes) -> np.ndarray:
    shape, dtype, buf = msgpack.unpackb(data, raw=True)
    return np.frombuffer(buf, dtype=np.dtype(dtype.decode())).reshape(shape)


def _ext_hook(code: int, data: bytes):
    if code == _EXT_NDARRAY:
        return _unpack_array(data)
    if code == _EXT_NPSCALAR:
        return _unpack_array(data)[()]
    return msgpack.ExtType(code, data)


def _pack_default(obj):
    if isinstance(obj, torch.Tensor):
        obj = obj.detach().cpu().numpy()
    if isinstance(obj, np.ndarray):  # tobytes() is C order; 0-d stays 0-d
        return msgpack.ExtType(_EXT_NDARRAY, msgpack.packb(
            (obj.shape, obj.dtype.name, obj.tobytes()), use_bin_type=True))
    raise TypeError(f"cannot serialise {type(obj)}")


def _to_state_dict(tree) -> Dict[str, torch.Tensor]:
    """A flax tree ({"params": {...}}) or a flat port map -> state_dict."""
    if isinstance(tree, Mapping) and "params" in tree:
        return unet_state_dict_from_flax(tree)
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _to_adamw_state(tree) -> Dict[str, Dict[str, torch.Tensor]]:
    """An optax chain state or the port's {name: {...}} map -> AdamW state
    by parameter name ({} when the checkpoint holds none)."""
    if not tree:
        return {}
    if is_optax_state(tree):
        return adamw_state_from_optax(tree)
    return {name: {k: torch.from_numpy(np.array(v)) for k, v in entry.items()}
            for name, entry in tree.items()}


def _args_dir(root: str, arg_num) -> str:
    return os.path.join(root, "model", f"diff-params-ARGS={arg_num}")


def _jsonable(o):
    if isinstance(o, (tuple, set)):
        return list(o)
    try:
        return o.item()
    except AttributeError:
        return str(o)


def save_checkpoint(root: str, args: Dict[str, Any], epoch: int,
                    model_state: Mapping[str, torch.Tensor],
                    ema_state: Mapping[str, torch.Tensor],
                    opt_state: Mapping[str, Mapping[str, torch.Tensor]],
                    final: bool = False, loss: float = 0.0) -> str:
    """Write a checkpoint of the model's and the EMA's `state_dict`s and
    AdamW's state by parameter name (`training.optimizer_state`; {} for
    none); returns its directory."""
    base = _args_dir(root, args["arg_num"])
    path = (os.path.join(base, "params-final") if final
            else os.path.join(base, "checkpoint", f"diff_epoch={epoch}"))
    payload = {"model": dict(model_state), "ema": dict(ema_state),
               "opt": dict(opt_state)}
    meta = {"n_epoch": int(epoch), "args": dict(args), "loss": float(loss)}
    tmp = path + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    with open(os.path.join(tmp, "payload.msgpack"), "wb") as f:
        f.write(msgpack.packb(payload, default=_pack_default, use_bin_type=True))
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump(meta, f, default=_jsonable)
    if os.path.exists(path):
        shutil.rmtree(path)
    os.replace(tmp, path)
    return path


def _read(path: str) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    with open(os.path.join(path, "payload.msgpack"), "rb") as f:
        raw = msgpack.unpackb(f.read(), ext_hook=_ext_hook, raw=False,
                              strict_map_key=False)
    payload = {"model": _to_state_dict(raw["model"]),
               "ema": _to_state_dict(raw["ema"]),
               "opt": _to_adamw_state(raw.get("opt"))}
    return payload, meta


def _periodic(root: str, arg_num) -> List[str]:
    """The periodic checkpoint directories, newest first (raises if there
    is no checkpoint directory)."""
    ckpt_dir = os.path.join(_args_dir(root, arg_num), "checkpoint")
    entries = sorted(((int(m.group(1)), n) for n in os.listdir(ckpt_dir)
                      if (m := re.match(r"diff_epoch=(\d+)$", n))),
                     reverse=True)
    return [os.path.join(ckpt_dir, name) for _, name in entries]


def latest_checkpoint_path(root: str, arg_num) -> Optional[str]:
    """The newest periodic checkpoint directory, or None."""
    if not os.path.isdir(os.path.join(_args_dir(root, arg_num), "checkpoint")):
        return None
    paths = _periodic(root, arg_num)
    return paths[0] if paths else None


def purge_checkpoints(root: str, arg_num) -> None:
    """Delete the periodic checkpoints (after the final save)."""
    ckpt_dir = os.path.join(_args_dir(root, arg_num), "checkpoint")
    if os.path.isdir(ckpt_dir):
        shutil.rmtree(ckpt_dir)


def load_checkpoint(root: str, arg_num, use_checkpoint: bool = False):
    """(payload, meta) of params-final, or (use_checkpoint) of the newest
    periodic checkpoint that reads cleanly, skipping corrupt ones; the
    payload's "model" and "ema" are `state_dict`s and its "opt" AdamW's
    state by parameter name."""
    if not use_checkpoint:
        return _read(os.path.join(_args_dir(root, arg_num), "params-final"))
    last_err: Optional[Exception] = None
    for path in _periodic(root, arg_num):
        try:
            return _read(path)
        except (OSError, ValueError, KeyError, TypeError,
                msgpack.UnpackException) as e:  # corrupt: try the next-newest
            last_err = e
    raise FileNotFoundError(f"no loadable checkpoint under "
                            f"{_args_dir(root, arg_num)}/checkpoint") from last_err


def load_parameters(root: str, token: str, use_checkpoint: bool = False):
    """(args, payload, meta) for the detection entry point, with args recovered
    from inside the checkpoint."""
    arg_num = normalise_arg_token(str(token))
    payload, meta = load_checkpoint(root, arg_num, use_checkpoint)
    args = defaultdict_from_json(meta["args"])
    args["arg_num"] = arg_num
    if args["img_size"] != "":
        args["img_size"] = tuple(args["img_size"])
    if "noise_fn" not in meta["args"]:
        args["noise_fn"] = "gauss"
    return args, payload, meta
