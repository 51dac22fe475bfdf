"""The yardstick: the card's peaks, the FLOPs of the UNet counted on the
frozen reference, the bytes bounds of kernels K2 and K2b, and the kinds of
device operations.

- FLOPs: `torch.utils.flop_counter.FlopCounterMode` (convolutions and
  matmuls) over one forward of `reference.unet` on the meta device, as
  `anoddpm_torch/bench.py` (`count_flops`, `unet_fwd_flops`) and
  `anoddpm_torch/campaigns/chain_flops.py` count them on the port's model;
  a train step's FLOPs are those of its forward and backward.
- Peaks: `anoddpm_torch/bench.py:53` (989.4 TFLOP/s, H100 SXM5 bf16 dense)
  and `chip_smoke.py:172` (3.35e12 bytes/s of HBM).
- Bytes bounds: `chip_smoke.py:497` (K2: x read once and the output
  written once) and `chip_smoke.py:572-573` (K2b: x, the incoming gradient
  and dx once each, gamma, beta, dgamma and dbeta in fp32, the (N, 32) mean
  and rstd).
- Kinds: `anoddpm_torch/campaigns/trace_categories.py:44-65` (`KINDS`,
  `kind_of`).
"""

from __future__ import annotations

import functools
import json
import re

import torch
from torch.utils.flop_counter import FlopCounterMode

from ..reference import unet as ru

PEAK_BF16_FLOPS = 989.4e12
HBM_BYTES_PER_S = 3.35e12

KINDS = [  # first match wins
    ("K1 simplex field", r"octave_field"),
    ("K2b group_norm_silu backward", r"group_norm_silu_bwd"),
    ("K2 group_norm_silu", r"group_norm_silu_kernel"),
    ("conv backward (dgrad, wgrad)", r"dgrad|wgrad"),
    ("conv forward", r"conv|fprop|implicit"),
    ("layout transpose", r"nchwToNhwc|nhwcToNchw|nchw.*nhwc|nhwc.*nchw"),
    ("matmul", r"gemm|cutlass|xmma"),
    ("AdamW (fused)", r"fused_adam|FusedAdam|adam"),
    ("foreach (clip, EMA, grad zeroing)", r"multi_tensor_apply|foreach"),
    ("softmax", r"softmax"),
    ("elementwise", r"elementwise|CatArrayBatched|index"),
    ("reduction", r"reduce"),
]
K2_NAME = re.compile(r"group_norm_silu_kernel")
K2B_NAME = re.compile(r"group_norm_silu_bwd")


def kind_of(name: str) -> str:
    for kind, pattern in KINDS:
        if re.search(pattern, name, re.IGNORECASE):
            return kind
    return "other"


def _img(cfg: dict) -> int:
    size = cfg["img_size"]
    return int(size[0] if isinstance(size, (list, tuple)) else size)


@functools.lru_cache(maxsize=None)
def _flops(cfg_json: str, backward: bool) -> int:
    cfg = json.loads(cfg_json)
    with torch.device("meta"):
        model = ru.unet_of(cfg)
        x = torch.zeros((1, 1, _img(cfg), _img(cfg)))
        t = torch.zeros((1,), dtype=torch.int64)
    counter = FlopCounterMode(display=False)
    with counter:
        if backward:
            model(x, t).square().mean().backward()
        else:
            with torch.no_grad():
                model(x, t)
    return counter.get_total_flops()


def forward_flops_per_image(cfg: dict) -> int:
    return _flops(json.dumps(cfg, sort_keys=True), False)


def train_flops_per_image(cfg: dict) -> int:
    return _flops(json.dumps(cfg, sort_keys=True), True)


def _site_bytes(cfg: dict, batch: int):
    """(numel, element size, channels) of every K2 site of one forward: the
    compute dtype's size inside the blocks, fp32 at the output norm."""
    block = 2 if str(cfg.get("compute_dtype", "bfloat16")) == "bfloat16" else 4
    out = []
    for shape, where in ru.norm_sites(cfg, batch):
        numel = 1
        for d in shape:
            numel *= d
        out.append((numel, 4 if where == "out" else block, shape[1]))
    return out


def k2_bytes_per_forward(cfg: dict, batch: int) -> int:
    return sum(2 * n * e for n, e, _ in _site_bytes(cfg, batch))


def k2b_bytes_per_step(cfg: dict, batch: int) -> int:
    return sum(3 * n * e + 4 * c * 4 + 2 * batch * 32 * 4
               for n, e, c in _site_bytes(cfg, batch))


def k2_sites(cfg: dict) -> int:
    return len(ru.norm_sites(cfg, 1))
