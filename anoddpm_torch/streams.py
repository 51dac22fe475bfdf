"""The random streams a run draws from, behind one interface.

A stream is a `torch.Generator` (config key `rng: "torch"`, the default)
or a `compat.jax_random.JaxKey` (`rng: "jax"`: the JAX package's own
threefry draws).  Every draw and every split in the port goes through
`of(stream)`, whose view has the same methods for both, so that no other
module tells the two apart:

- `split(num)`, `fold_in(data)` and `fold_in_static(suffix)`: a JaxKey's
  `jax.random.split` and `fold_in`, and flax's fold-in of a module path,
  placed where the JAX package places them; a torch.Generator is one
  stream drawn in order, so it stands for every part of a split and for
  its own fold-in, and draws in the same order as before;
- `randint`, `seeds` and `normal`: t, K1's uint32 seeds and Gaussian noise
  on the stream's device.  A JaxKey's randint and seeds are made on the
  host and copied from pinned memory (no sync); its normal is drawn on
  its device, in the JAX package's NHWC layout, and transposed;
- `bernoulli`, `choice` and `permutation`: coins and dropout masks, t drawn
  by a loss-weight table, and the table path's permutations.  A JaxKey's
  are `jax.random`'s, made on the host and copied as randint's, except
  a dropout-sized bernoulli, which is drawn on the device (in NHWC, as
  flax draws it, and transposed);
- `dropout(x, rate)`: flax's `nn.Dropout` with the JaxKey as its rng, or
  `F.dropout` (torch's global generator, as before) for a
  torch.Generator;
- `hand_on(mesh)`: after rank 0 alone drew, the other ranks take its
  generator's state; every rank splits a JaxKey alike, so there is
  nothing to hand on.

Splits and fold-ins return plain streams (a torch.Generator or a JaxKey),
so a caller that takes a generator keeps taking one.
"""

from __future__ import annotations

from typing import Tuple, Union

import torch
import torch.nn.functional as F

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

    def fold_in_static(self, suffix) -> Stream:
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

    def bernoulli(self, p: float, shape) -> torch.Tensor:
        return torch.rand(tuple(shape), generator=self.generator,
                          device=self.device) < p

    def choice(self, p: torch.Tensor, n: int) -> torch.Tensor:
        return torch.multinomial(host_to(p, self.device), n, replacement=True,
                                 generator=self.generator)

    def permutation(self, n: int, size: int) -> torch.Tensor:
        keys = torch.rand((n, size), generator=self.generator,
                          device=self.device)
        return keys.argsort(dim=1)

    def dropout(self, x: torch.Tensor, rate: float) -> torch.Tensor:
        return F.dropout(x, rate, True)

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

    def fold_in_static(self, suffix) -> Stream:
        return jr.fold_in_static(self.key, suffix)

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

    def bernoulli(self, p: float, shape) -> torch.Tensor:
        if len(shape) == 4:     # a dropout mask: flax draws it in NHWC
            b, c, h, w = shape
            return jr.bernoulli(self.key, p, (b, h, w, c)).permute(0, 3, 1, 2)
        return host_to(jr.bernoulli(self.key.on("cpu"), p, shape), self.device)

    def choice(self, p: torch.Tensor, n: int) -> torch.Tensor:
        return host_to(jr.choice(self.key.on("cpu"), p, (n,)), self.device)

    def permutation(self, n: int, size: int) -> torch.Tensor:
        """n permutations of range(size): the key split in n, one
        `jax.random.permutation` each (the JAX table path's)."""
        perms = torch.stack([jr.permutation(k.on("cpu"), size)
                             for k in self.key.split(n)])
        return host_to(perms, self.device)

    def dropout(self, x: torch.Tensor, rate: float) -> torch.Tensor:
        """flax's `nn.Dropout` (flax 0.12.3, `linen/stochastic.py:92-107`)
        with this key as its rng: x / keep where `bernoulli(key, keep,
        NHWC shape)`, else 0; keep rounded to x's dtype, as JAX rounds a
        Python float against a bf16 array."""
        if rate == 0:
            return x
        if rate == 1:
            return torch.zeros_like(x)
        keep = 1.0 - rate
        mask = self.bernoulli(keep, x.shape)
        scale = float(torch.tensor(keep, dtype=torch.float64).to(x.dtype))
        return torch.where(mask, x / scale, 0.0)

    def hand_on(self, mesh) -> None:
        pass


def of(stream: Stream) -> Union[_TorchView, _JaxView]:
    """The view every draw and split of `stream` goes through."""
    return _JaxView(stream) if isinstance(stream, JaxKey) else _TorchView(stream)
