"""Sub-seeds of a run's `--seed`: any whole number, mixed with tags into a
63-bit seed for torch and numpy generators."""

from __future__ import annotations

import hashlib


def sub_seed(seed: int, *tags) -> int:
    text = ":".join([str(int(seed))] + [str(t) for t in tags])
    return int.from_bytes(hashlib.sha256(text.encode()).digest()[:8], "little") >> 1
