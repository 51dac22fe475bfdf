"""Checkpoint save/load in the JAX package's layout, where args travel
inside the checkpoint:

    model/diff-params-ARGS={n}/params-final/                  final save
    model/diff-params-ARGS={n}/checkpoint/diff_epoch={e}/     periodic saves

Each directory holds `payload.msgpack` ({"model", "ema", "opt"}) and
`meta.json` ({"n_epoch", "args", "loss"}).

The payload is read with plain `msgpack`: arrays are flax's extension type
1, a packed (shape, dtype name, bytes) triple.  A payload written by the JAX
package holds flax parameter trees, which are converted to the port's
`state_dict` on load; one written by the port holds `state_dict`s, stored
as flat {name: array} maps in the same encoding.
"""

from __future__ import annotations

import json
import os
import re
import shutil
from typing import Any, Dict, Mapping, Optional, Tuple

import msgpack
import numpy as np
import torch

from .compat.flax_params import unet_state_dict_from_flax
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
    if isinstance(obj, np.ndarray):
        arr = np.ascontiguousarray(obj)
        return msgpack.ExtType(_EXT_NDARRAY, msgpack.packb(
            (arr.shape, arr.dtype.name, arr.tobytes()), use_bin_type=True))
    raise TypeError(f"cannot serialise {type(obj)}")


def _to_state_dict(tree) -> Dict[str, torch.Tensor]:
    """A flax tree ({"params": {...}}) or a flat port map -> state_dict."""
    if isinstance(tree, Mapping) and "params" in tree:
        return unet_state_dict_from_flax(tree)
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


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
                    ema_state: Mapping[str, torch.Tensor], final: bool = False,
                    loss: float = 0.0) -> str:
    """Write a checkpoint (no optimizer state yet: the port does not train);
    returns its directory."""
    base = _args_dir(root, args["arg_num"])
    path = (os.path.join(base, "params-final") if final
            else os.path.join(base, "checkpoint", f"diff_epoch={epoch}"))
    payload = {"model": dict(model_state), "ema": dict(ema_state), "opt": {}}
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
               "ema": _to_state_dict(raw["ema"]), "opt": raw.get("opt")}
    return payload, meta


def load_checkpoint(root: str, arg_num, use_checkpoint: bool = False):
    """Load params-final, or (use_checkpoint) the newest checkpoint that
    reads cleanly, skipping corrupt ones."""
    base = _args_dir(root, arg_num)
    if not use_checkpoint:
        return _read(os.path.join(base, "params-final"))
    ckpt_dir = os.path.join(base, "checkpoint")
    entries = sorted(((int(m.group(1)), n) for n in os.listdir(ckpt_dir)
                      if (m := re.match(r"diff_epoch=(\d+)$", n))),
                     reverse=True)
    last_err: Optional[Exception] = None
    for _, name in entries:
        try:
            return _read(os.path.join(ckpt_dir, name))
        except (OSError, ValueError, KeyError, TypeError,
                msgpack.UnpackException) as e:  # corrupt: try the next-newest
            last_err = e
    raise FileNotFoundError(f"no loadable checkpoint under {ckpt_dir}") from last_err


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
