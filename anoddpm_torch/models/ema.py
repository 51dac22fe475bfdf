"""Exponential moving average of the UNet's parameters.

Counterpart of `anoddpm_tpu/models/ema.py`: the EMA model starts as a copy
of the model, and every train step moves it by
ema <- decay * ema + (1 - decay) * p, here in place with `torch._foreach_*`
over the parameter lists (two launches for the whole model on the card).
"""

from __future__ import annotations

import copy
from typing import Sequence

import torch
import torch.nn as nn


def init_ema(model: nn.Module) -> nn.Module:
    """A copy of `model` that takes no gradients, in eval mode."""
    ema = copy.deepcopy(model)
    ema.requires_grad_(False)
    return ema.eval()


@torch.no_grad()
def ema_update(ema_params: Sequence[torch.Tensor],
               params: Sequence[torch.Tensor], decay: float = 0.9999) -> None:
    """ema <- decay * ema + (1 - decay) * params, in place."""
    ema_params, params = list(ema_params), list(params)
    torch._foreach_mul_(ema_params, decay)
    torch._foreach_add_(ema_params, params, alpha=1.0 - decay)
