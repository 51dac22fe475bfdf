"""Import the reference's PyTorch UNet checkpoints into the port.

Counterpart of `anoddpm_tpu/compat/torch_import.py:29-156`, without the
flax detour: the reference's `params-final.pt` state_dict (its UNet.py
module tree) becomes the port's `state_dict` directly.  The port's UNet is
NCHW like the reference, so only names change, and the reference's Conv1d
QKV and output projections (O, I, 1) lose their last axis to become dense
weights (O, I).  The walk replays the reference's module construction
order (down.k, middle.k, up.k) against the port's flax-style names.
"""

from __future__ import annotations

from typing import Any, Dict, Sequence

import numpy as np
import torch

from ..models.unet import DEFAULT_CHANNEL_MULTS


def _tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float32).clone()
    return torch.from_numpy(np.array(x, np.float32))


def import_reference_unet_state(state_dict: Dict[str, Any], img_size: int,
                                base_channels: int,
                                channel_mults: Sequence[float] = (),
                                num_res_blocks: int = 2,
                                attention_resolutions: str = "32,16,8",
                                in_channels: int = 1) -> Dict[str, torch.Tensor]:
    """The reference UNet's state_dict (tensors or numpy arrays) as the
    port UNet's `state_dict` (fp32 CPU tensors)."""
    del in_channels   # the shapes come with the weights
    sd = state_dict
    mults = tuple(channel_mults) or DEFAULT_CHANNEL_MULTS[img_size]
    attention_ds = [img_size // int(r)
                    for r in str(attention_resolutions).split(",")]
    out: Dict[str, torch.Tensor] = {}

    def take(ref: str, port: str, squeeze: bool = False) -> None:
        for leaf in ("weight", "bias"):
            value = _tensor(sd[f"{ref}.{leaf}"])
            if squeeze and leaf == "weight":
                value = value[..., 0]
            out[f"{port}.{leaf}"] = value

    def resblock(ref: str, port: str, has_skip: bool) -> None:
        take(f"{ref}.in_layers.0", f"{port}.norm_in")
        take(f"{ref}.in_layers.2", f"{port}.conv_in")
        take(f"{ref}.embed_layers.1", f"{port}.emb_proj")
        take(f"{ref}.out_layers.0", f"{port}.norm_out")
        take(f"{ref}.out_layers.3", f"{port}.conv_out")
        if has_skip:
            take(f"{ref}.skip_connection", f"{port}.skip")

    def attention(ref: str, port: str) -> None:
        take(f"{ref}.norm", f"{port}.norm")
        take(f"{ref}.to_qkv", f"{port}.qkv", squeeze=True)
        take(f"{ref}.proj_out", f"{port}.proj", squeeze=True)

    take("time_embedding.1", "time_dense1")
    take("time_embedding.3", "time_dense2")
    take("down.0.0", "stem")

    index = 1   # the reference's down-list index
    ch = int(mults[0] * base_channels)
    chans = [ch]
    ds = 1
    for i, mult in enumerate(mults):
        out_ch = int(base_channels * mult)
        for j in range(num_res_blocks):
            resblock(f"down.{index}.0", f"down_{i}_{j}", ch != out_ch)
            ch = out_ch
            if ds in attention_ds:
                attention(f"down.{index}.1", f"down_attn_{i}_{j}")
            chans.append(ch)
            index += 1
        if i != len(mults) - 1:
            resblock(f"down.{index}.0", f"down_sample_{i}", False)
            ds *= 2
            chans.append(ch)
            index += 1

    resblock("middle.0", "mid_res1", False)
    attention("middle.1", "mid_attn")
    resblock("middle.2", "mid_res2", False)

    index = 0
    for i, mult in reversed(list(enumerate(mults))):
        out_ch = int(base_channels * mult)
        for j in range(num_res_blocks + 1):
            in_ch = ch + chans.pop()
            resblock(f"up.{index}.0", f"up_{i}_{j}", in_ch != out_ch)
            ch = out_ch
            sub = 1
            if ds in attention_ds:
                attention(f"up.{index}.{sub}", f"up_attn_{i}_{j}")
                sub += 1
            if i and j == num_res_blocks:
                resblock(f"up.{index}.{sub}", f"up_sample_{i}", False)
                ds //= 2
            index += 1

    take("out.0", "out_norm")
    take("out.2", "out_conv")
    return out


def load_reference_checkpoint(path: str, img_size: int, base_channels: int,
                              use_ema: bool = True,
                              **kwargs) -> Dict[str, torch.Tensor]:
    """A reference params-final.pt (its EMA weights, or the model's when
    `use_ema` is off or it holds no EMA) as the port UNet's `state_dict`."""
    payload = torch.load(path, map_location="cpu")
    sd = (payload["ema"] if use_ema and "ema" in payload
          else payload["model_state_dict"])
    return import_reference_unet_state(sd, img_size, base_channels, **kwargs)
