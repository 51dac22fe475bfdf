"""Host input pipeline: batching, infinite cycling and prefetch to the
device.

Own copy of `anoddpm_tpu/data/pipeline.py:19-58` (`cycle`,
`batch_iterator`, numpy only).  `prefetch_to_device` is the port's: a
background thread stacks substeps, keeps this rank's rows under a mesh,
turns each NHWC numpy batch into an NCHW tensor, pins it and copies it to
the card with `non_blocking=True`, so that the copy overlaps the steps
before it.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, Iterator

import numpy as np
import torch


def cycle(iterable_factory: Callable[[], Iterator]):
    """Infinite iterator; re-creates the underlying iterator each epoch
    (shuffling datasets reshuffle per pass)."""
    while True:
        for x in iterable_factory():
            yield x


def batch_iterator(dataset, batch_size: int, shuffle: bool = True,
                   drop_last: bool = True, seed: int = 0,
                   collate_keys=("image", "mask")):
    """Endless passes over `dataset`, yielding dict batches with stacked
    arrays (DataLoader(batch, shuffle, drop_last) semantics)."""
    rng = np.random.default_rng(seed)

    def one_pass(epoch_seed):
        order = np.arange(len(dataset))
        if shuffle:
            np.random.default_rng(epoch_seed).shuffle(order)
        for start in range(0, len(order), batch_size):
            idxs = order[start:start + batch_size]
            if drop_last and len(idxs) < batch_size:
                return
            samples = [dataset[int(i)] for i in idxs]
            batch: Dict[str, object] = {}
            for k in samples[0]:
                vals = [s[k] for s in samples]
                if k in collate_keys and isinstance(vals[0], np.ndarray):
                    batch[k] = np.stack(vals)
                else:
                    batch[k] = vals
            yield batch

    epoch = 0
    while True:
        yield from one_pass(int(rng.integers(0, 2 ** 31)) if shuffle else epoch)
        epoch += 1


def to_nchw(array: np.ndarray) -> torch.Tensor:
    """An NHWC numpy batch (or (S, B, H, W, C) substeps) as a contiguous
    NCHW float32 tensor (a copy)."""
    return torch.from_numpy(np.ascontiguousarray(
        np.moveaxis(np.asarray(array), -1, -3), np.float32))


def to_nhwc(x: torch.Tensor) -> np.ndarray:
    """An NCHW tensor (or (F, B, C, H, W) frames) on any device as NHWC
    numpy."""
    return x.movedim(-3, -1).cpu().numpy()


class _Failed:
    """The producer's exception, handed to the consumer to raise."""

    def __init__(self, error: Exception):
        self.error = error


def stack_substeps(it: Iterator, substeps: int):
    """Groups of `substeps` consecutive batches as one: every ndarray value
    gains a leading substep axis, (substeps, B, ...), so that masks stay
    aligned with images, and every other value becomes the list of the
    per-substep values.  A partial group at the end is dropped."""
    while True:
        group = []
        for _ in range(substeps):
            try:
                group.append(next(it))
            except StopIteration:
                return
        batch: Dict[str, object] = {}
        for k in group[0]:
            vals = [g[k] for g in group]
            batch[k] = np.stack(vals) if isinstance(vals[0], np.ndarray) else vals
        yield batch


def prefetch_to_device(it: Iterator, device: torch.device, size: int = 2,
                       keys=("image",), substeps: int = 1, mesh=None):
    """Yield `it`'s batches with the NHWC arrays under `keys` as NCHW
    tensors on `device`, prepared `size` batches ahead on a background
    thread (pinned and copied asynchronously when `device` is a card).

    With `substeps` > 1 each item stacks that many batches
    (`stack_substeps`): the tensors are (substeps, B, C, H, W).  Under a
    `parallel.Mesh` the arrays under `keys` keep this rank's rows of every
    step's global batch (every rank iterates the same seeded order).  An
    exception in the thread is raised here; closing the generator stops
    the thread."""
    device = torch.device(device)
    q: "queue.Queue" = queue.Queue(maxsize=size)
    stop = threading.Event()
    done = object()
    source = stack_substeps(iter(it), substeps) if substeps > 1 else it
    batch_axis = 1 if substeps > 1 else 0

    def place(batch):
        out = dict(batch)
        for k in keys:
            if k in out and isinstance(out[k], np.ndarray):
                arr = out[k]
                if mesh is not None:
                    arr = mesh.shard_batch(arr, batch_axis)
                t = to_nchw(arr)
                if device.type == "cuda":
                    t = t.pin_memory().to(device, non_blocking=True)
                out[k] = t.to(device)
        return out

    def put(item):
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return
            except queue.Full:
                pass

    def producer():
        try:
            for item in source:
                if stop.is_set():
                    return
                put(place(item))
            put(done)
        except Exception as e:  # the thread's boundary: the consumer raises it
            put(_Failed(e))

    thread = threading.Thread(target=producer, name="prefetch_to_device",
                              daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is done:
                return
            if isinstance(item, _Failed):
                raise item.error
            yield item
    finally:
        stop.set()
        thread.join(timeout=10)
