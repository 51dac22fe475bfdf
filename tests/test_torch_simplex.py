"""Kernel K1's plain version and the noise samplers against the JAX
package: the lattice hash exactly, the octave field within fp32 tolerance,
and the (sample, channel) layout of the simplex sampler."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anoddpm_tpu.ops import noise as jnoise
from anoddpm_tpu.ops import simplex as sx
from anoddpm_torch.ops import noise as tnoise
from anoddpm_torch.ops import simplex as tsx


def test_hash_grad_id_equals_jax():
    rng = np.random.default_rng(0)
    pts = rng.integers(-2**20, 2**20, size=(3, 4096)).astype(np.int32)
    seeds = rng.integers(0, 2**32, size=4096, dtype=np.uint64).astype(np.uint32)
    want = np.asarray(sx._hash_grad_id(jnp.asarray(seeds), *map(jnp.asarray, pts)))
    got = tsx._hash_grad_id(torch.from_numpy(seeds.astype(np.int64)),
                            *(torch.from_numpy(p) for p in pts))
    np.testing.assert_array_equal(got.numpy(), want)


def test_grad_components_equal_jax():
    gid = np.arange(24, dtype=np.int32)
    want = sx._grad_components(jnp.asarray(gid), jnp.float32)
    got = tsx._grad_components(torch.from_numpy(gid.astype(np.int64)))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_octave_field_matches_jax():
    """Same uint32 seeds and per-field t: |delta| <= 1e-5 on >= 99.7% of the
    pixels (a floor() may flip at a lattice-cell boundary where XLA fuses an
    FMA, ops/simplex.py:758-761), all finite."""
    key = jax.random.key(3)
    n, hw = 3, (64, 64)
    t = np.array([5.0, 120.0, 777.0], np.float32)
    want = np.asarray(sx.batched_fractal3_fixed_t(key, hw, jnp.asarray(t),
                                                  n_fields=n))
    seeds = np.asarray(sx.seeds_from_key(key, n)).astype(np.int64)
    got = tsx.batched_fractal3_fixed_t(torch.from_numpy(seeds),
                                       torch.from_numpy(t), hw).numpy()
    assert got.shape == (n, 64, 64) and np.isfinite(got).all()
    assert (np.abs(got - want) <= 1e-5).mean() >= 0.997
    assert got.std() > 0.1


def test_octave_schedule():
    sched = tsx.octave_schedule(3, 0.8, 64.0)
    assert [s for s, _ in sched] == [1 / 64, 2 / 64, 4 / 64]
    assert sched[2][1] == float(np.float32(np.float32(0.8) * np.float32(0.8)))


@pytest.mark.parametrize("share_batch", [False, True])
def test_simplex_sampler_layout_matches_jax(monkeypatch, share_batch):
    """With the JAX key's seeds injected, the NCHW sampler output is the
    JAX NHWC output transposed: field (b, c) sits at sample b, channel c
    on the plane z = t[b]."""
    key = jax.random.key(7)
    b, c, h, w = 2, 3, 16, 16
    t = np.array([4, 9], np.int32)
    want = np.asarray(jnoise.simplex_noise(key, (b, h, w, c), jnp.asarray(t),
                                           share_batch=share_batch))
    n = c if share_batch else b * c
    seeds = torch.from_numpy(np.asarray(sx.seeds_from_key(key, n)).astype(np.int64))
    monkeypatch.setattr(tnoise, "_seeds", lambda k, g: seeds[:k])
    gen = torch.Generator().manual_seed(0)
    got = tnoise.simplex_noise((b, c, h, w), torch.from_numpy(t), gen,
                               share_batch=share_batch).numpy()
    np.testing.assert_allclose(got, want.transpose(0, 3, 1, 2), atol=1e-5)


def test_samplers_from_args():
    gen = torch.Generator().manual_seed(1)
    s = tnoise.sampler_from_args({"noise_fn": "simplex", "simplex_octaves": 2})
    assert s.fingerprint == ("simplex", 2, 0.8, 64.0, False, False)
    out = s((2, 1, 8, 8), torch.tensor([3, 3]), gen)
    assert out.shape == (2, 1, 8, 8) and out.dtype == torch.float32
    assert not torch.equal(out[0], out[1])  # independent fields per sample
    g = tnoise.sampler_from_args({"noise_fn": "gauss"})
    assert g.fingerprint == ("gauss",)
    a = g((2, 1, 4, 4), None, torch.Generator().manual_seed(5))
    assert torch.equal(a, g((2, 1, 4, 4), None, torch.Generator().manual_seed(5)))
    for kind in ("simplex_randParam", "simplex_2d", "random"):
        out = tnoise.make_noise_sampler(kind)((2, 1, 8, 8), torch.tensor([3, 3]), gen)
        assert out.shape == (2, 1, 8, 8) and torch.isfinite(out).all()
    s = tnoise.sampler_from_args({"noise_fn": "simplex", "simplex_table": True})
    assert s.fingerprint == ("simplex", 6, 0.8, 64.0, False, True)
    assert s((1, 1, 8, 8), torch.tensor([3]), gen).shape == (1, 1, 8, 8)
