"""Observability: structured metrics logging, step timing and a profiler
window.

`MetricsLogger` and `StepTimer` are own copies of `anoddpm_tpu/observe.py`:
metrics/args{n}-train.jsonl gets one JSON object per logging step (loss,
grad norm, throughput, wall time).  `ProfileWindow` traces one training
epoch with `torch.profiler` (host and, on a card, device activity) when
ANODDPM_PROFILE_DIR is set, and writes it as a Chrome trace.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional

import torch


class MetricsLogger:
    """Append-only JSONL metrics writer."""

    def __init__(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self.path = path
        self._f = open(path, "a", buffering=1)
        self._t0 = time.time()

    def log(self, step: int, **metrics: Any) -> None:
        rec: Dict[str, Any] = {"step": int(step),
                               "wall_time": round(time.time() - self._t0, 3)}
        for k, v in metrics.items():
            try:
                rec[k] = float(v)
            except (TypeError, ValueError):
                rec[k] = v
        self._f.write(json.dumps(rec) + "\n")

    def close(self) -> None:
        self._f.close()


class ProfileWindow:
    """Trace ONE steady training epoch with `torch.profiler`.

    Active only when ANODDPM_PROFILE_DIR is set.  It traces relative epoch
    1 (the second of the run, after the first steps' warm-up), or
    ANODDPM_PROFILE_EPOCH, and writes {dir}/{name}/trace.json, which
    chrome://tracing or Perfetto opens."""

    def __init__(self, name: str = "train", epoch_index: int = 1):
        self.dir = os.environ.get("ANODDPM_PROFILE_DIR")
        self.epoch_index = int(
            os.environ.get("ANODDPM_PROFILE_EPOCH", epoch_index))
        self.name = name
        self._prof: Optional[torch.profiler.profile] = None

    def start_epoch(self, rel_epoch: int) -> None:
        if self.dir and self._prof is None and rel_epoch == self.epoch_index:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(activities=activities)
            self._prof.__enter__()

    def end_epoch(self, rel_epoch: int) -> None:
        if self._prof is not None and rel_epoch == self.epoch_index:
            self.stop()

    def stop(self) -> None:
        if self._prof is not None:
            prof, self._prof = self._prof, None
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            prof.__exit__(None, None, None)
            out = os.path.join(self.dir, self.name)
            os.makedirs(out, exist_ok=True)
            prof.export_chrome_trace(os.path.join(out, "trace.json"))


class StepTimer:
    """Steady-state step timing with warmup exclusion."""

    def __init__(self, warmup: int = 2):
        self.warmup = warmup
        self.count = 0
        self.total = 0.0
        self._last: Optional[float] = None

    def tick(self) -> Optional[float]:
        now = time.time()
        dt = None
        if self._last is not None:
            dt = now - self._last
            self.count += 1
            if self.count > self.warmup:
                self.total += dt
        self._last = now
        return dt

    @property
    def mean(self) -> float:
        steady = self.count - self.warmup
        return self.total / steady if steady > 0 else float("nan")
