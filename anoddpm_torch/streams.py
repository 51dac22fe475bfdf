"""The random streams a run draws from, behind one interface.

A stream is a `torch.Generator` (config key `rng: "torch"`, the default)
or a `compat.jax_random.JaxKey` (`rng: "jax"`: the JAX package's own
threefry draws).  Every draw and every split in the port goes through
`of(stream)`, whose view has the same methods for both, so that no other
module tells the two apart:

- `split(num)` and `fold_in(data)`: a JaxKey's `jax.random.split` and
  `fold_in`, placed where the JAX package places them; a torch.Generator is
  one stream drawn in order, so it stands for every part of a split and
  for its own fold-in, and draws in the same order as before;
- `randint`, `seeds` and `normal`: t, K1's uint32 seeds and Gaussian noise
  on the stream's device.  A JaxKey's randint and seeds are made on the
  host and copied from pinned memory (no sync); its normal is drawn on
  its device, in the JAX package's NHWC layout, and transposed;
- `torch_generator(what)`: the generator behind a draw whose JAX stream
  the port does not follow; under a JaxKey it raises, naming `what`,
  rather than draw from another stream;
- `hand_on(mesh)`: after rank 0 alone drew, the other ranks take its
  generator's state; every rank splits a JaxKey alike, so there is
  nothing to hand on.

Splits and fold-ins return plain streams (a torch.Generator or a JaxKey),
so a caller that takes a generator keeps taking one.
"""

from __future__ import annotations

from typing import Tuple, Union

import torch

from .compat import jax_random as jr
from .compat.jax_random import JaxKey

Stream = Union[torch.Generator, JaxKey]
RNGS = ("torch", "jax")


def rng_of(args) -> str:
    """The config's `rng`: "torch" (the default) or "jax"."""
    rng = str(args.get("rng") or "torch")
    if rng not in RNGS:
        raise ValueError(f"rng must be one of {RNGS}, got {rng!r}")
    return rng


def make(args, seed: int, device) -> Stream:
    """The stream a run seeded `seed` draws from on `device`: a
    torch.Generator, or under `rng: "jax"` the JaxKey `key(seed)`."""
    if rng_of(args) == "jax":
        return jr.key(seed, device)
    return torch.Generator(device=torch.device(device)).manual_seed(seed)


def torch_only(args, what: str) -> None:
    """Raise under `rng: "jax"` for an entry point whose JAX key schedule
    the port does not follow, rather than draw from torch's streams."""
    if rng_of(args) == "jax":
        raise NotImplementedError(_no_jax_stream(what))


def _no_jax_stream(what: str) -> str:
    return (f"{what} has no JAX stream in the port (rng: jax); run it with "
            f"rng: torch")


def host_to(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A host tensor on `device`; to a card from pinned memory, which does
    not synchronise."""
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


class _TorchView:
    """A torch.Generator: one stream drawn in order."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator
        self.device = generator.device

    def split(self, num: int = 2) -> Tuple[Stream, ...]:
        return (self.generator,) * int(num)

    def fold_in(self, data: int) -> Stream:
        return self.generator

    def randint(self, shape, high: int) -> torch.Tensor:
        return torch.randint(0, high, tuple(shape), generator=self.generator,
                             device=self.device)

    def seeds(self, n: int) -> torch.Tensor:
        return torch.randint(0, 1 << 32, (n,), generator=self.generator,
                             device=self.device, dtype=torch.int64)

    def normal(self, shape) -> torch.Tensor:
        return torch.randn(tuple(shape), generator=self.generator,
                           device=self.device, dtype=torch.float32)

    def torch_generator(self, what: str) -> torch.Generator:
        return self.generator

    def hand_on(self, mesh) -> None:
        if mesh is not None:
            mesh.broadcast_generator(self.generator)


class _JaxView:
    """A JaxKey: the JAX package's draws, split where it splits."""

    def __init__(self, key: JaxKey):
        self.key = key
        self.device = key.device

    def split(self, num: int = 2) -> Tuple[Stream, ...]:
        return self.key.split(num)

    def fold_in(self, data: int) -> Stream:
        return self.key.fold_in(data)

    def randint(self, shape, high: int) -> torch.Tensor:
        return host_to(jr.randint(self.key.on("cpu"), shape, 0, high),
                       self.device)

    def seeds(self, n: int) -> torch.Tensor:
        return host_to(jr.bits(self.key.on("cpu"), (n,)), self.device)

    def normal(self, shape) -> torch.Tensor:
        if len(shape) != 4:
            return jr.normal(self.key, shape)
        b, c, h, w = shape
        return jr.normal(self.key, (b, h, w, c)).permute(0, 3, 1, 2)

    def torch_generator(self, what: str) -> torch.Generator:
        raise NotImplementedError(_no_jax_stream(what))

    def hand_on(self, mesh) -> None:
        pass


def of(stream: Stream) -> Union[_TorchView, _JaxView]:
    """The view every draw and split of `stream` goes through."""
    return _JaxView(stream) if isinstance(stream, JaxKey) else _TorchView(stream)
