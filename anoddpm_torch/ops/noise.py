"""Noise sources for the diffusion process.

Counterpart of `anoddpm_tpu/ops/noise.py`.  A sampler is a function
`(shape, t, generator) -> tensor`: `shape` is NCHW, `t` the (B,) timesteps,
and the result lies on the generator's device, with every random draw (the
Gaussian values, the lattice-hash seeds) made there from that generator.

By default every (sample, channel) pair gets its own simplex field;
`share_batch=True` repeats one field per channel over the batch, as the
reference does.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from . import simplex as sx

NoiseSampler = Callable[[Tuple[int, ...], torch.Tensor, torch.Generator],
                        torch.Tensor]

_LATER = "is not ported yet (ROADMAP.md, Queue 1: noise variants)"


def _seeds(n: int, generator: torch.Generator) -> torch.Tensor:
    """n uint32 lattice-hash seeds, as int64, drawn on the generator's device."""
    return torch.randint(0, 1 << 32, (n,), generator=generator,
                         device=generator.device, dtype=torch.int64)


def gaussian_noise(shape: Tuple[int, ...], t: torch.Tensor,
                   generator: torch.Generator) -> torch.Tensor:
    del t
    return torch.randn(tuple(shape), generator=generator,
                       device=generator.device, dtype=torch.float32)


gaussian_noise.fingerprint = ("gauss",)


def simplex_noise(shape: Tuple[int, ...], t: torch.Tensor,
                  generator: torch.Generator, octaves: int = 6,
                  persistence: float = 0.8, frequency: float = 64.0,
                  share_batch: bool = False) -> torch.Tensor:
    """Multi-octave simplex field(s) for NCHW `shape`; the field of sample b
    lies on the plane z = t[b].  One launch of kernel K1 per call."""
    b, c, h, w = shape
    t = torch.broadcast_to(torch.as_tensor(t, dtype=torch.float32,
                                           device=generator.device), (b,))
    if share_batch:
        # One field per channel at t[0], repeated over the batch.
        fields = sx.batched_fractal3_fixed_t(
            _seeds(c, generator), t[:1].expand(c).contiguous(), (h, w),
            octaves, persistence, frequency)                       # (C, H, W)
        return fields.unsqueeze(0).expand(b, c, h, w)
    fields = sx.batched_fractal3_fixed_t(
        _seeds(b * c, generator), t.repeat_interleave(c), (h, w),
        octaves, persistence, frequency)                           # (B*C, H, W)
    return fields.view(b, c, h, w)


def make_noise_sampler(kind: str, octaves: int = 6, persistence: float = 0.8,
                       frequency: float = 64.0, share_batch: bool = False,
                       table: bool = False) -> NoiseSampler:
    """Noise dispatch by config kind.  This slice has "gauss" and "simplex"
    (any kind the JAX package does not name falls through to simplex, as
    there); the other kinds raise.

    Every sampler carries a `fingerprint`: the tuple of its construction
    parameters."""
    if kind == "gauss":
        return gaussian_noise
    if kind in ("simplex_randParam", "simplex_2d", "random"):
        raise NotImplementedError(f"noise kind {kind!r} {_LATER}")
    if table:
        raise NotImplementedError(f"simplex_table=True {_LATER}")

    def simplex_sampler(shape, t, generator):
        return simplex_noise(shape, t, generator, octaves, persistence,
                             frequency, share_batch)
    simplex_sampler.fingerprint = ("simplex", octaves, persistence, frequency,
                                   share_batch, table)
    return simplex_sampler


def sampler_from_args(args) -> NoiseSampler:
    return make_noise_sampler(
        str(args.get("noise_fn", "gauss") or "gauss"),
        octaves=int(args.get("simplex_octaves", 6) or 6),
        persistence=float(args.get("simplex_persistence", 0.8) or 0.8),
        frequency=float(args.get("simplex_frequency", 64) or 64),
        table=bool(args.get("simplex_table", False)),
    )
