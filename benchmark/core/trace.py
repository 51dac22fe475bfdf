"""The device timeline of a traced window, from `torch.profiler` (CUPTI).

`Window` opens at a synchronise and closes at one, with the profiler on
in between and a `bench.window` annotation around it; the benchmark's
own host spans inside are `bench.*` annotations.  After it closes, the
device's operations (kernels, copies, sets; not the device side of the
annotations) are clipped to the annotated window and summarised: busy
time (the union of their intervals), time by kernel name, and the idle
gaps with the innermost `bench.*` span that the host was in at each
gap's middle.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch.profiler import ProfilerActivity, profile, record_function

from . import yardstick as ys


class Summary:
    """What the readers take from a traced window."""

    def __init__(self, window_s: float, busy_s: float,
                 by_name: Dict[str, Tuple[float, int]],
                 gaps: List[Tuple[str, float]], units: Dict[str, int]):
        self.window_s = window_s
        self.busy_s = busy_s
        self.by_name = by_name        # name -> (device seconds, calls)
        self.gaps = gaps              # (span, seconds), longest first
        self.units = units            # work in the window: forwards, steps

    def seconds_of(self, pattern) -> Tuple[float, int]:
        secs, calls = 0.0, 0
        for name, (s, n) in self.by_name.items():
            if pattern.search(name):
                secs += s
                calls += n
        return secs, calls

    def breakdown(self, top: int = 10) -> Dict[str, list]:
        kinds: Dict[str, float] = defaultdict(float)
        for name, (s, _) in self.by_name.items():
            kinds[ys.kind_of(name)] += s
        ops = sorted(kinds.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[k, v] for k, v in ops],
                "idle_gaps": [[k, v] for k, v in self.gaps[:top]]}


def span(name: str):
    """A host span of the benchmark, seen by the profiler when it is on."""
    return record_function(f"bench.{name}")


class Window:
    """Open with `start()`, close with `stop(units)`; `summary` then holds
    the reading.  `sync` waits for the device."""

    def __init__(self, sync: Callable[[], None]):
        self.sync = sync
        self.prof = None
        self.marks = []
        self.summary: Optional[Summary] = None

    def start(self, inside: Optional[str] = None) -> None:
        """`inside`: the span the host is in when the window opens within
        it (the profiler sees only spans that open after it starts)."""
        self.sync()
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.start()
        self.marks = [record_function("bench.window")]
        if inside:
            self.marks.append(span(inside))
        for mark in self.marks:
            mark.__enter__()

    def stop(self, units: Dict[str, int]) -> None:
        self.sync()
        for mark in reversed(self.marks):
            mark.__exit__(None, None, None)
        self.prof.stop()
        self.summary = _summarise(self.prof, units)
        self.prof = None


def _summarise(prof, units: Dict[str, int]) -> Summary:
    device, spans = [], []
    lo = hi = None
    for e in prof.profiler.kineto_results.events():
        start, dur = e.start_ns(), e.duration_ns()
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if not e.is_user_annotation():
                device.append((start, start + dur, e.name()))
        elif e.is_user_annotation() and e.name().startswith("bench."):
            if e.name() == "bench.window":
                lo, hi = start, start + dur
            else:
                spans.append((start, start + dur, e.name()[6:]))
    if lo is None:
        raise RuntimeError("the traced window's annotation is missing")
    by_name: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0])
    intervals = []
    for s, e, name in device:
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        by_name[name][0] += (e - s) / 1e9
        by_name[name][1] += 1
        intervals.append((s, e))
    intervals.sort()
    busy, gaps, cursor = 0, [], lo
    for s, e in intervals:
        if s > cursor:
            gaps.append((cursor, s))
        if e > cursor:
            busy += e - max(s, cursor)
            cursor = e
    if hi > cursor:
        gaps.append((cursor, hi))
    labelled = []
    for s, e in sorted(gaps, key=lambda g: g[0] - g[1])[:10]:
        mid = (s + e) / 2
        inside = [sp for sp in spans if sp[0] <= mid <= sp[1]]
        label = (min(inside, key=lambda sp: sp[1] - sp[0])[2] if inside
                 else "outside the spans")
        labelled.append((label, (e - s) / 1e9))
    return Summary((hi - lo) / 1e9, busy / 1e9,
                   {k: (v[0], int(v[1])) for k, v in by_name.items()},
                   labelled, units)
