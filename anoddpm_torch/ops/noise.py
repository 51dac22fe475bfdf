"""Noise sources for the diffusion process.

Counterpart of `anoddpm_tpu/ops/noise.py`.  A sampler is a function
`(shape, t, generator) -> tensor`: `shape` is NCHW, `t` the (B,) timesteps,
and the result lies on the generator's device, with every random draw (the
Gaussian values, the lattice-hash seeds) made there from that generator.

The generator may instead be a `compat.jax_random.JaxKey` (config key
`rng: "jax"`): every draw and split goes through `streams.of(generator)`,
so that a sampler draws what the JAX package's sampler draws from that
key: `bits(key, (B * C,))` as the seeds of simplex and simplex_2d,
`normal(key, NHWC shape)` for Gaussian noise, a split then `randint` of
the table row and the seeds for simplex_randParam, a split then a
`bernoulli` coin for random, and for the table path a split into one key
per field, each field's permutation `permutation(key, 256)`.  A
torch.Generator passes through the splits as itself and draws as before.

By default every (sample, channel) pair gets its own simplex field;
`share_batch=True` repeats one field per channel over the batch, as the
reference does.  Every kind is drawn on the device without a host sync:
randParam's triple is indexed on the card and read there by kernel K1,
and `random` draws both fields and picks one with a coin on the card.
"""

from __future__ import annotations

import functools
from typing import Callable, Tuple

import torch

from .. import streams
from ..streams import Stream
from . import simplex as sx

NoiseSampler = Callable[[Tuple[int, ...], torch.Tensor, Stream], torch.Tensor]

# The reference's 23 (octaves, persistence, frequency) triples of
# "simplex_randParam" (the JAX package's noise.py:30-36).
RAND_PARAM_TABLE = (
    (2, 0.6, 16), (6, 0.6, 32), (7, 0.7, 32), (10, 0.8, 64), (5, 0.8, 16),
    (4, 0.6, 16), (1, 0.6, 64), (7, 0.8, 128), (6, 0.9, 64), (2, 0.85, 128),
    (2, 0.85, 64), (2, 0.85, 32), (2, 0.85, 16), (2, 0.85, 8), (2, 0.85, 4),
    (2, 0.85, 2), (1, 0.85, 128), (1, 0.85, 64), (1, 0.85, 32), (1, 0.85, 16),
    (1, 0.85, 8), (1, 0.85, 4), (1, 0.85, 2),
)


@functools.lru_cache(maxsize=None)
def _rand_param_table(device: torch.device) -> torch.Tensor:
    """RAND_PARAM_TABLE as a (23, 3) fp32 tensor on `device`, made once (to
    a card from pinned memory, which does not synchronise)."""
    table = torch.tensor(RAND_PARAM_TABLE, dtype=torch.float32)
    if device.type == "cuda":
        return table.pin_memory().to(device, non_blocking=True)
    return table.to(device)


def _seeds(n: int, generator: Stream) -> torch.Tensor:
    """n uint32 lattice-hash seeds, as int64, on the generator's device:
    drawn there from a torch.Generator, or `bits(key, (n,))` of a JaxKey
    made on the host and copied."""
    return streams.of(generator).seeds(n)


def _perms(n: int, generator: Stream):
    """n permutation tables and their gradient ids, (n, 256) int64 each."""
    return sx.perm_tables(n, generator)


def _param_index(generator: Stream) -> torch.Tensor:
    """The row of RAND_PARAM_TABLE for one call, a 0-d tensor on the
    generator's device."""
    return streams.of(generator).randint((), len(RAND_PARAM_TABLE))


def _coin(generator: Stream) -> torch.Tensor:
    """A fair coin, a 0-d bool tensor on the generator's device."""
    return streams.of(generator).bernoulli(0.5, ())


def gaussian_noise(shape: Tuple[int, ...], t: torch.Tensor,
                   generator: Stream) -> torch.Tensor:
    del t
    return streams.of(generator).normal(shape)


gaussian_noise.fingerprint = ("gauss",)


def _plane_times(t, b: int, c: int, generator: Stream) -> torch.Tensor:
    """The (B * C,) fp32 planes of the (sample, channel) fields: t[b] for
    every channel of sample b (expanded, not `repeat_interleave`, which can
    read its size back from the card)."""
    t = torch.broadcast_to(torch.as_tensor(t, dtype=torch.float32,
                                           device=generator.device), (b,))
    return t[:, None].expand(b, c).reshape(b * c)


def simplex_noise(shape: Tuple[int, ...], t: torch.Tensor,
                  generator: Stream, octaves: int = 6,
                  persistence: float = 0.8, frequency: float = 64.0,
                  share_batch: bool = False, table: bool = False) -> torch.Tensor:
    """Multi-octave simplex field(s) for NCHW `shape`; the field of sample b
    lies on the plane z = t[b].  The hash path is one launch of kernel K1
    per call; `table=True` takes the table-exact path (a fresh permutation
    per field, plain PyTorch)."""
    b, c, h, w = shape
    t_fields = _plane_times(t, b, c, generator)
    n = c if share_batch else b * c
    if share_batch:
        # one field per channel at t[0], repeated over the batch
        t_fields = t_fields[:c].contiguous()
    if table:
        perms, gids = _perms(n, generator)
        fields = sx.batched_fractal3_fixed_t_table(
            perms, gids, t_fields, (h, w), octaves, persistence, frequency)
    else:
        fields = sx.batched_fractal3_fixed_t(
            _seeds(n, generator), t_fields, (h, w), octaves, persistence,
            frequency)
    if share_batch:
        return fields.unsqueeze(0).expand(b, c, h, w)
    return fields.view(b, c, h, w)


def simplex2d_noise(shape: Tuple[int, ...], t: torch.Tensor,
                    generator: Stream, octaves: int = 6,
                    persistence: float = 0.8,
                    frequency: float = 64.0) -> torch.Tensor:
    """Timestep-independent 2-D octave fields (hash path, plain PyTorch),
    one per (sample, channel); `t` is ignored."""
    del t
    b, c, h, w = shape
    fields = sx.batched_fractal2(_seeds(b * c, generator), (h, w), octaves,
                                 persistence, frequency)
    return fields.view(b, c, h, w)


def simplex_volume_noise(shape_zhw: Tuple[int, int, int],
                         generator: Stream, octaves: int = 1,
                         persistence: float = 0.5,
                         frequency: float = 32.0) -> torch.Tensor:
    """A (Z, H, W) octave volume whose z-coordinate is an axis of the output,
    from one fresh seed: one K1 launch on the card."""
    return sx.fractal3_volume_hash(_seeds(1, generator)[0], tuple(shape_zhw),
                                   octaves, persistence, frequency)


def simplex_rand_param_noise(shape: Tuple[int, ...], t: torch.Tensor,
                             generator: Stream) -> torch.Tensor:
    """Simplex fields with one (octaves, persistence, frequency) triple per
    call, drawn on the device from RAND_PARAM_TABLE and shared by every
    (sample, channel) field, as the JAX package does (PARITY.md): one launch
    of K1's parameters-from-device entry, no host sync."""
    b, c, h, w = shape
    key_param, key_seeds = streams.of(generator).split()
    index = _param_index(key_param)
    params = torch.index_select(_rand_param_table(index.device), 0,
                                index.reshape(1))[0]
    fields = sx.batched_fractal3_fixed_t_params(
        _seeds(b * c, key_seeds), _plane_times(t, b, c, generator), (h, w),
        params)
    return fields.view(b, c, h, w)


simplex_rand_param_noise.fingerprint = ("simplex_randParam",)


def make_noise_sampler(kind: str, octaves: int = 6, persistence: float = 0.8,
                       frequency: float = 64.0, share_batch: bool = False,
                       table: bool = False) -> NoiseSampler:
    """Noise dispatch by config kind: "gauss" | "simplex" |
    "simplex_randParam" | "simplex_2d" | "random"; any other kind falls
    through to simplex, as in the JAX package, and `table` is ignored by
    randParam and 2-D there too.

    Every sampler carries a `fingerprint`: the tuple of its construction
    parameters."""
    if kind == "gauss":
        return gaussian_noise
    if kind == "simplex_randParam":
        return simplex_rand_param_noise
    if kind == "simplex_2d":
        def simplex2d_sampler(shape, t, generator):
            return simplex2d_noise(shape, t, generator, octaves, persistence,
                                   frequency)
        simplex2d_sampler.fingerprint = ("simplex_2d", octaves, persistence,
                                         frequency)
        return simplex2d_sampler
    if kind == "random":
        def random_noise(shape, t, generator):
            # both drawn, the coin picks on the device: no host sync
            key_flip, key_noise = streams.of(generator).split()
            coin = _coin(key_flip)
            gauss = gaussian_noise(shape, t, key_noise)
            simplex = simplex_noise(shape, t, key_noise, octaves, persistence,
                                    frequency, share_batch, table)
            return torch.where(coin, gauss, simplex)
        random_noise.fingerprint = ("random", octaves, persistence, frequency,
                                    share_batch, table)
        return random_noise

    def simplex_sampler(shape, t, generator):
        return simplex_noise(shape, t, generator, octaves, persistence,
                             frequency, share_batch, table)
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
