"""Where the port's entry points run.

They run on the card unless the caller asks for the CPU.  Without a card and
without an explicit CPU request they raise: they never carry on quietly on
the CPU.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """`device` as a `torch.device`; None means the card, which must exist."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available: pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)
