"""jax.random's default implementation, threefry2x32, in torch.

The JAX package draws every random number from `jax.random` with its
default PRNG, threefry2x32 (`jax/_src/prng.py` of JAX 0.9.0).  A draw is a
fixed function of a key's two uint32 words: 20 rounds of 32-bit add,
rotate and xor over a counter.  This module computes the same words and
the same values in torch, so that the port can train and detect on the
JAX package's own draws (config key `rng: "jax"`).

Torch has no uint32 shifts on the CPU, so every word is held in an int64
(a Python int or an int64 tensor) and masked with `& 0xFFFFFFFF` after
each add and shift; `threefry2x32` serves both kinds alike.  A key is a
`JaxKey`: its two words as Python ints and the device its draws land on.
The counters are laid out as under `jax_threefry_partitionable`, JAX
0.9.0's default (True), which is what the JAX package runs with; the
original layout is not reproduced.  Splits and fold-ins are computed
on the host from the words alone (no tensor, no launch); `bits`,
`uniform`, `normal`, `truncated_normal` and `randint` build their counters
on `key.device`.  A caller that wants a small draw on the host and its
copy on a card draws on a CPU key (`JaxKey.on`) and copies it itself.

Where the values are floats they follow `jax/_src/random.py`: uniform from
the top 23 bits of each word (`_uniform`, :435-477), normal as sqrt(2)
times the inverse error function of a uniform on (nextafter(-1, 0), 1)
(`_normal_real`, :867-872), truncated_normal through the error function of
its bounds and a clamp to the open interval (`_truncated_normal`,
:1005-1025).  The inverse error function is `torch.special.erfinv`, not
XLA's polynomial: `normal` and `truncated_normal` stand within a few fp32
ulps of JAX's (the bound is held in `tests/test_torch_jax_random.py`);
`key`, `split`, `fold_in`, `bits`, `uniform` and `randint` are bit-equal.
"""

from __future__ import annotations

import dataclasses
import hashlib
import math
from typing import Sequence, Tuple, Union

import numpy as np
import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
# draws of at most this many words on the host go through numpy
_HOST_NUMPY = 1 << 16

Word = Union[int, torch.Tensor]
DeviceLike = Union[str, torch.device, None]


def _rotl(x: Word, d: int) -> Word:
    return ((x << d) & MASK) | (x >> (32 - d))


def threefry2x32(k0: int, k1: int, x0: Word, x1: Word) -> Tuple[Word, Word]:
    """The Threefry-2x32 hash of the counter pair (x0, x1) under the key
    (k0, k1): `prng.py` `_threefry2x32_lowering` (:883-944), five groups of
    four rounds with the key schedule injected after each.  x0 and x1 are
    Python ints, int64 numpy arrays or int64 tensors in [0, 2^32); so are
    the results."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + k0) & MASK
    x1 = (x1 + k1) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK
    return x0, x1


@dataclasses.dataclass(frozen=True)
class JaxKey:
    """A jax.random key: its two uint32 words and the device its draws
    land on."""
    words: Tuple[int, int]
    device: torch.device = torch.device("cpu")

    def split(self, num: int = 2) -> Tuple["JaxKey", ...]:
        return split(self, num)

    def fold_in(self, data: int) -> "JaxKey":
        return fold_in(self, data)

    def on(self, device: DeviceLike) -> "JaxKey":
        """The same key, drawing on `device`."""
        return dataclasses.replace(self, device=torch.device(device or "cpu"))


def key(seed: int, device: DeviceLike = None) -> JaxKey:
    """`jax.random.key(seed)` without x64: `prng.threefry_seed` (:802-829)
    on the seed converted to 32 bits, (0, seed mod 2^32)."""
    seed = int(seed)
    if not -(1 << 63) <= seed < (1 << 64):
        raise OverflowError(f"seed {seed} does not fit 64 bits")
    return JaxKey((0, seed & MASK), torch.device(device or "cpu"))


def _with_words(k: JaxKey, words) -> JaxKey:
    return dataclasses.replace(k, words=(int(words[0]), int(words[1])))


def split(k: JaxKey, num: int = 2) -> Tuple[JaxKey, ...]:
    """`jax.random.split(key, num)`, computed on the host
    (`prng._threefry_split_foldlike`, :1156-1161): key i hashes the counter
    (0, i)."""
    return tuple(_with_words(k, threefry2x32(*k.words, 0, i))
                 for i in range(int(num)))


def fold_in(k: JaxKey, data: int) -> JaxKey:
    """`jax.random.fold_in(key, data)` (`prng._threefry_fold_in`,
    :1168-1170): the hash of (0, data) for data in [0, 2^32)."""
    data = int(data)
    if not 0 <= data <= MASK:
        raise OverflowError(f"fold_in data {data} out of bounds for uint32")
    return _with_words(k, threefry2x32(*k.words, 0, data))


def fold_in_static(k: JaxKey, suffix: Sequence) -> JaxKey:
    """flax's `_fold_in_static` (flax 0.12.3, `flax/core/scope.py:110-134`):
    one fold_in of the first four bytes of the SHA-1 of the suffix's names
    (UTF-8) and counts (big-endian bytes), with no separator, as
    `flax_fix_rng_separator` is off by default."""
    if not suffix:
        return k
    m = hashlib.sha1()
    for x in suffix:
        if isinstance(x, str):
            m.update(x.encode("utf-8"))
        elif isinstance(x, int):
            m.update(x.to_bytes((x.bit_length() + 7) // 8, byteorder="big"))
        else:
            raise ValueError(f"expected int or str, got {x!r}")
    return fold_in(k, int.from_bytes(m.digest()[:4], byteorder="big"))


def _shape(shape) -> Tuple[int, ...]:
    return (int(shape),) if isinstance(shape, int) else tuple(int(s) for s in shape)


def bits(k: JaxKey, shape: Sequence[int] = ()) -> torch.Tensor:
    """`jax.random.bits(key, shape, uint32)` as int64 in [0, 2^32) on
    `k.device` (`_threefry_random_bits_partitionable`, :1184-1201):
    element i hashes the 64-bit counter i as (hi, lo) and keeps the xor of
    the two words."""
    shape = _shape(shape)
    n = math.prod(shape)
    if k.device.type == "cpu" and n <= _HOST_NUMPY:
        # a small host draw: numpy's int64 ops cost ~1 us where torch's
        # cost ~10, and a train step makes several such draws
        counts = np.arange(n, dtype=np.int64)
        b0, b1 = threefry2x32(*k.words, counts >> 32, counts & MASK)
        return torch.from_numpy(b0 ^ b1).reshape(shape)
    counts = torch.arange(n, dtype=torch.int64, device=k.device)
    b0, b1 = threefry2x32(*k.words, counts >> 32, counts & MASK)
    return (b0 ^ b1).reshape(shape)


def _fp32(v) -> float:
    """v rounded to fp32, as a Python float."""
    return float(np.float32(v))


def uniform(k: JaxKey, shape: Sequence[int] = (), minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """`jax.random.uniform(key, shape, float32, minval, maxval)`: the top 23
    bits of each word as the mantissa of a float in [1, 2), minus 1, times
    (maxval - minval), plus minval, and no less than minval.  XLA on the
    CPU contracts the product and the sum into one fused multiply-add (one
    rounding); float64 holds the product exactly, so the sum in float64
    rounded to fp32 gives the same bits.  The bounds are Python floats, so
    that a draw on a card makes no tensor from a host value (which would
    sync)."""
    w = bits(k, shape)
    floats = (((w >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
              - 1.0)
    lo = _fp32(minval)
    scale = _fp32(np.float32(maxval) - np.float32(lo))
    return torch.clamp((floats.double() * scale + lo).float(), min=lo)


_SQRT2 = _fp32(math.sqrt(2.0))


def normal(k: JaxKey, shape: Sequence[int] = ()) -> torch.Tensor:
    """`jax.random.normal(key, shape, float32)`: sqrt(2) erfinv(u), u
    uniform on [nextafter(-1, 0), 1)."""
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    return torch.special.erfinv(uniform(k, shape, lo, 1.0)) * _SQRT2


def truncated_normal(k: JaxKey, lower: float, upper: float,
                     shape: Sequence[int] = ()) -> torch.Tensor:
    """`jax.random.truncated_normal(key, lower, upper, shape, float32)`:
    sqrt(2) erfinv(u), u uniform on [erf(lower / sqrt 2), erf(upper /
    sqrt 2)), clamped to (nextafter(lower, inf), nextafter(upper, -inf));
    the bounds' erf in fp32 on the host (XLA's value at +-2)."""
    lower, upper = np.float32(lower), np.float32(upper)
    a, b = torch.erf(torch.tensor([lower, upper]) / _SQRT2).tolist()
    out = torch.special.erfinv(uniform(k, shape, a, b)) * _SQRT2
    inf = np.float32(np.inf)
    return torch.clamp(out, float(np.nextafter(lower, inf)),
                       float(np.nextafter(upper, -inf)))


_I32 = (-(1 << 31), (1 << 31) - 1)


def randint(k: JaxKey, shape: Sequence[int], minval: int,
            maxval: int) -> torch.Tensor:
    """`jax.random.randint(key, shape, minval, maxval)` in int32, returned
    as int64 on `k.device` (`_randint`, :581-657): two words a value from
    the two halves of a split, reduced mod the span as JAX reduces them in
    uint32, with minval and maxval clipped to the int32 range."""
    shape = _shape(shape)
    minval, maxval = int(minval), int(maxval)
    out_of_range = maxval > _I32[1]
    lo_v = min(max(minval, _I32[0]), _I32[1])
    hi_v = min(max(maxval, _I32[0]), _I32[1])
    k1, k2 = split(k)
    higher, lower = bits(k1, shape), bits(k2, shape)
    host = k.device.type == "cpu" and math.prod(shape) <= _HOST_NUMPY
    if host:
        higher, lower = higher.numpy(), lower.numpy()
    span = (hi_v - lo_v) & MASK
    if hi_v <= lo_v:
        span = 1
    elif out_of_range:
        span = (span + 1) & MASK
    if span == 0:
        # a span of 2^32 wraps to 0 in uint32, and XLA's x % 0 is x
        offset = lower
    else:
        multiplier = (1 << 16) % span
        multiplier = ((multiplier * multiplier) & MASK) % span
        offset = ((((higher % span) * multiplier) & MASK)
                  + lower % span) & MASK
        offset = offset % span
    value = (lo_v + offset) & MASK
    value = value - ((value > _I32[1]) * (1 << 32))
    return torch.from_numpy(np.asarray(value)) if host else value


def bernoulli(k: JaxKey, p: float = 0.5,
              shape: Sequence[int] = ()) -> torch.Tensor:
    """`jax.random.bernoulli(key, p, shape)` in its default mode "low" with
    a Python float p: `uniform(key, shape, float32) < fp32(p)` (`_bernoulli`,
    :1075-1089), as a bool tensor on `k.device`."""
    return uniform(k, shape) < _fp32(p)


def _xla_cumsum(x: np.ndarray) -> np.ndarray:
    """`jnp.cumsum` of a 1-D fp32 array as XLA on the CPU sums it: its
    reduce-window rewrite scans blocks of 16 in order and adds to each
    block the exclusive scan of the block sums, found the same way."""
    n = x.shape[0]
    blocks = np.concatenate([x, np.zeros(-n % 16, np.float32)]).reshape(-1, 16)
    local = np.cumsum(blocks, axis=1, dtype=np.float32)
    sums = local[:, -1]
    carry = (_xla_cumsum(sums) if sums.shape[0] > 16
             else np.cumsum(sums, dtype=np.float32))
    carry = np.concatenate([np.zeros(1, np.float32), carry[:-1]])
    return (local + carry[:, None]).reshape(-1)[:n]


def choice(k: JaxKey, p: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """`jax.random.choice(key, len(p), shape, replace=True, p=p)` for fp32
    probabilities p on the host, returned as int64 on `k.device` (`choice`,
    :810-814): the index of the first entry of cumsum(p) at or above
    cumsum(p)[-1] * (1 - uniform), cumsum summed in XLA's order."""
    shape = _shape(shape)
    cum = _xla_cumsum(np.asarray(p, np.float32).reshape(-1))
    u = uniform(k.on("cpu"), shape).numpy()
    r = cum[-1] * (np.float32(1.0) - u)
    idx = np.searchsorted(cum, r, side="left").astype(np.int64)
    return torch.from_numpy(idx).reshape(shape).to(k.device)


def permutation(k: JaxKey, n: int) -> torch.Tensor:
    """`jax.random.permutation(key, n)` as int64 on `k.device` (`_shuffle`,
    :700-728): ceil(3 ln n / ln(2^32 - 1)) rounds, each splitting the key
    into (key, subkey) and sorting the values stably by `bits(subkey)`."""
    n = int(n)
    rounds = int(np.ceil(3 * np.log(max(1, n)) / np.log(MASK)))
    x = torch.arange(n, dtype=torch.int64, device=k.device)
    for _ in range(rounds):
        k, sub = split(k)
        order = torch.sort(bits(sub, (n,)).to(k.device), stable=True).indices
        x = x[order]
    return x
