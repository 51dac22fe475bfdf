"""The rest of the simplex module and every noise kind of the port against
the JAX package: the LCG permutation tables exactly, the table-exact 3-D
walk, the 2-D walk, the hash volume, the masked octave field and the
randParam / random / 2-D / table samplers with their draws injected."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anoddpm_tpu.ops import noise as jnoise
from anoddpm_tpu.ops import simplex as jsx
from anoddpm_torch.ops import noise as tnoise
from anoddpm_torch.ops import simplex as tsx

# K1's standing rule, and the table path's (a floor() may flip at a
# lattice-cell boundary where XLA fuses an FMA, anoddpm_tpu/ops/simplex.py
# :758-761): |delta| <= 1e-5 on >= 99.7% of the values.
TOL, SHARE = 1e-5, 0.997


def within(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    return (np.abs(got - want) <= tol).mean()


def t64(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


@pytest.mark.parametrize("seed", [3, 12345, -9876543210, 9999999999])
def test_perm_tables_from_seed_exact(golden, seed):
    g = golden(f"golden_perm_{seed}.npz")
    perm, gid = tsx.perm_tables_from_seed(seed)
    jperm, jgid = jsx.perm_tables_from_seed(seed)
    np.testing.assert_array_equal(perm, g["perm"])
    np.testing.assert_array_equal(gid * 3, g["perm_grad_index3"])
    np.testing.assert_array_equal(perm, jperm)
    np.testing.assert_array_equal(gid, jgid)


def test_perm_tables_from_generator():
    gen = torch.Generator().manual_seed(4)
    perm, gid = tsx.perm_tables(3, gen)
    assert perm.shape == (3, 256) and perm.dtype == torch.int64
    for row in perm:
        assert sorted(row.tolist()) == list(range(256))
    assert torch.equal(gid, perm % 24)
    assert not torch.equal(perm[0], perm[1])
    again, _ = tsx.perm_tables(3, torch.Generator().manual_seed(4))
    assert torch.equal(perm, again)


def test_opensimplex3_table_matches_jax_and_golden(golden):
    g = golden("golden_noise3.npz")
    pts = g["pts"].astype(np.float32)
    perm, gid = g["perm"], g["pgi"] // 3
    want = np.asarray(jsx.opensimplex3(jnp.asarray(perm, jnp.int32),
                                       jnp.asarray(gid, jnp.int32),
                                       *(jnp.asarray(pts[:, i]) for i in range(3))))
    got = tsx.opensimplex3(t64(perm), t64(gid),
                           *(torch.from_numpy(pts[:, i].copy()) for i in range(3)))
    assert within(got, want) >= SHARE
    # against the float64 reference scalar kernel, as the JAX test holds it
    err = np.abs(got.numpy() - g["vals"])
    assert np.median(err) < 1e-6 and (err < 1e-4).mean() > 0.99


def test_fractal3_fixed_t_table_matches_jax_and_golden(golden):
    g = golden("golden_octave_field.npz")
    perm, gid = g["perm"], g["pgi"] // 3
    want = np.asarray(jsx.fractal3_fixed_t(
        jnp.asarray(perm, jnp.int32), jnp.asarray(gid, jnp.int32), (16, 24),
        7.0, octaves=4, persistence=0.8, frequency=8.0))
    got = tsx.fractal3_fixed_t(t64(perm), t64(gid), (16, 24), 7.0, octaves=4,
                               persistence=0.8, frequency=8.0)
    assert within(got, want) >= SHARE
    err = np.abs(got.numpy() - g["field"][0])
    assert np.median(err) < 1e-5 and (err < 1e-3).mean() > 0.99


def test_fractal3_volume_table_matches_jax():
    perm, gid = jsx.perm_tables_from_seed(3)
    want = jsx.fractal3_volume(jnp.asarray(perm), jnp.asarray(gid), (5, 12, 16),
                               octaves=3, persistence=0.6, frequency=8.0)
    got = tsx.fractal3_volume(t64(perm), t64(gid), (5, 12, 16), octaves=3,
                              persistence=0.6, frequency=8.0)
    assert within(got, want) >= SHARE


def _jax_table_fields(key, hw, t, n, octaves):
    """JAX's per-field table fields as `batched_fractal3_fixed_t_table`
    defines them, `fractal3_fixed_t` on each field's permutation, run
    eagerly: on this CPU the jitted vmap of it differs from its own eager
    form on ~2% of the pixels (by up to 1.85 at 24 x 20), the port does
    not.  Returns the fields and the (perms, gids) drawn from `key`."""
    perms, gids = jax.vmap(jsx.perm_tables_from_key)(jax.random.split(key, n))
    fields = np.stack([np.asarray(jsx.fractal3_fixed_t(
        perms[i], gids[i], hw, float(t[i]), octaves=octaves)) for i in range(n)])
    return fields, perms, gids


def test_batched_table_fields_match_jax():
    """Per-field permutations (the JAX key's tables injected) on per-field
    planes, one gather table per field."""
    key = jax.random.key(8)
    n, hw = 3, (24, 20)
    t = np.array([3.0, 50.0, 199.0], np.float32)
    want, perms, gids = _jax_table_fields(key, hw, t, n, 3)
    got = tsx.batched_fractal3_fixed_t_table(t64(perms), t64(gids),
                                             torch.from_numpy(t), hw, octaves=3)
    assert got.shape == (n,) + hw
    assert within(got, want) >= SHARE


def test_opensimplex2_matches_jax_and_golden(golden):
    g = golden("golden_noise2.npz")
    pts = g["pts"].astype(np.float32)
    perm = g["perm"]
    want = np.asarray(jsx.opensimplex2(jnp.asarray(perm, jnp.int32),
                                       jnp.asarray(pts[:, 0]), jnp.asarray(pts[:, 1])))
    got = tsx.opensimplex2(t64(perm), torch.from_numpy(pts[:, 0].copy()),
                           torch.from_numpy(pts[:, 1].copy()))
    assert within(got, want) >= SHARE
    err = np.abs(got.numpy() - g["vals"])
    assert np.median(err) < 1e-6 and (err < 1e-4).mean() > 0.99


def test_fractal2_matches_jax_and_golden(golden):
    g = golden("golden_noise2.npz")
    perm = g["perm"]
    want = np.asarray(jsx.fractal2(jnp.asarray(perm, jnp.int32), (16, 16),
                                   octaves=4, persistence=0.8, frequency=8.0))
    got = tsx.fractal2(t64(perm), (16, 16), octaves=4, persistence=0.8,
                       frequency=8.0)
    assert within(got, want) >= SHARE
    err = np.abs(got.numpy() - g["field"])
    assert np.median(err) < 1e-5 and (err < 1e-3).mean() > 0.99


def test_opensimplex2_hash_matches_jax():
    rng = np.random.default_rng(5)
    pts = rng.uniform(-300, 300, size=(2, 4096)).astype(np.float32)
    seeds = rng.integers(0, 2 ** 32, size=4096, dtype=np.uint64).astype(np.uint32)
    want = np.asarray(jsx.opensimplex2_hash(jnp.asarray(seeds), jnp.asarray(pts[0]),
                                            jnp.asarray(pts[1])))
    got = tsx.opensimplex2_hash(t64(seeds), torch.from_numpy(pts[0].copy()),
                                torch.from_numpy(pts[1].copy()))
    assert within(got, want) >= SHARE


def test_grad_components2_equal_table():
    gx, gy = tsx._grad_components2(torch.arange(8))
    np.testing.assert_array_equal(torch.stack([gx, gy], 1).numpy(),
                                  jsx.GRADIENTS2)


def test_batched_fractal2_matches_jax():
    key = jax.random.key(6)
    n, hw = 3, (32, 24)
    want = np.asarray(jsx.batched_fractal2(key, hw, n_fields=n, octaves=6,
                                           persistence=0.8, frequency=16.0))
    seeds = np.asarray(jsx.seeds_from_key(key, n))
    got = tsx.batched_fractal2(t64(seeds), hw, 6, 0.8, 16.0)
    assert got.shape == (n,) + hw
    assert within(got, want) >= SHARE


def test_fractal3_volume_hash_matches_jax():
    seed = np.uint32(99)
    want = np.asarray(jsx.fractal3_volume_hash(jnp.uint32(seed), (6, 20, 28),
                                               octaves=3, persistence=0.5,
                                               frequency=16.0))
    got = tsx.fractal3_volume_hash(torch.tensor(int(seed)), (6, 20, 28),
                                   octaves=3, persistence=0.5, frequency=16.0)
    assert within(got, want) >= SHARE
    plane = tsx.fractal3_fixed_t_hash(torch.tensor(int(seed)), (20, 28), 4.0,
                                      octaves=3, persistence=0.5, frequency=16.0)
    assert torch.equal(got[4], plane)


@pytest.mark.parametrize("triple", jnoise.RAND_PARAM_TABLE)
def test_masked_field_matches_jax_at_every_triple(triple):
    """K1's parameters-from-device entry (its plain version) against
    `fractal3_fixed_t_masked` at each (octaves, persistence, frequency) of
    the table, and equal to the static-octave field."""
    octaves, pers, freq = triple
    seeds = np.array([12345, 4000000000], np.uint32)
    t = np.array([3.0, 150.0], np.float32)
    hw = (24, 32)
    want = np.stack([np.asarray(jsx.fractal3_fixed_t_masked(
        jnp.uint32(s), hw, float(ti), jnp.float32(octaves), jnp.float32(pers),
        jnp.float32(freq))) for s, ti in zip(seeds, t)])
    params = torch.tensor([octaves, pers, freq], dtype=torch.float32)
    got = tsx.batched_fractal3_fixed_t_params(t64(seeds), torch.from_numpy(t),
                                              hw, params)
    assert within(got, want) >= SHARE
    static = tsx.batched_fractal3_fixed_t(t64(seeds), torch.from_numpy(t), hw,
                                          octaves, float(np.float32(pers)),
                                          float(np.float32(freq)))
    assert torch.equal(got, static)


def test_rand_param_table_is_jax_table():
    assert tnoise.RAND_PARAM_TABLE == jnoise.RAND_PARAM_TABLE


def _injected_jax_rand_param(key, shape, t):
    """JAX's randParam draws: (index, seeds) from `key` as it splits it."""
    b, h, w, c = shape
    key_param, key_seeds = jax.random.split(key)
    idx = int(jax.random.randint(key_param, (), 0, len(jnoise.RAND_PARAM_TABLE)))
    seeds = np.asarray(jsx.seeds_from_key(key_seeds, b * c))
    return idx, seeds


@pytest.mark.parametrize("key_seed", [0, 5])
def test_rand_param_sampler_matches_jax(monkeypatch, key_seed):
    key = jax.random.key(key_seed)
    b, c, h, w = 2, 2, 24, 16
    t = np.array([7, 120], np.int32)
    want = np.asarray(jnoise.simplex_rand_param_noise(key, (b, h, w, c),
                                                      jnp.asarray(t)))
    idx, seeds = _injected_jax_rand_param(key, (b, h, w, c), t)
    monkeypatch.setattr(tnoise, "_param_index", lambda g: torch.tensor(idx))
    monkeypatch.setattr(tnoise, "_seeds", lambda n, g: t64(seeds)[:n])
    sampler = tnoise.make_noise_sampler("simplex_randParam")
    got = sampler((b, c, h, w), torch.from_numpy(t), torch.Generator())
    assert got.shape == (b, c, h, w)
    assert within(got.numpy(), want.transpose(0, 3, 1, 2)) >= SHARE


@pytest.mark.parametrize("coin", [True, False])
def test_random_sampler_matches_jax_composition(monkeypatch, coin):
    """`random`: with the coin injected, the Gaussian branch is the injected
    Gaussian, the simplex branch the simplex field of the injected seeds;
    both are drawn and the coin picks on the device."""
    b, c, h, w = 2, 1, 16, 16
    t = np.array([4, 9], np.int32)
    key = jax.random.key(2)
    jsimplex = np.asarray(jnoise.simplex_noise(key, (b, h, w, c), jnp.asarray(t)))
    seeds = np.asarray(jsx.seeds_from_key(key, b * c))
    gauss = np.random.default_rng(3).normal(size=(b, c, h, w)).astype(np.float32)
    monkeypatch.setattr(tnoise, "_coin", lambda g: torch.tensor(coin))
    monkeypatch.setattr(tnoise, "_seeds", lambda n, g: t64(seeds)[:n])
    monkeypatch.setattr(tnoise, "gaussian_noise",
                        lambda shape, t, g: torch.from_numpy(gauss))
    got = tnoise.make_noise_sampler("random")((b, c, h, w), torch.from_numpy(t),
                                              torch.Generator()).numpy()
    if coin:
        np.testing.assert_array_equal(got, gauss)
    else:
        assert within(got, jsimplex.transpose(0, 3, 1, 2)) >= SHARE


def test_simplex2d_sampler_matches_jax(monkeypatch):
    key = jax.random.key(11)
    b, c, h, w = 2, 2, 16, 24
    want = np.asarray(jnoise.simplex2d_noise(key, (b, h, w, c), None, octaves=3,
                                             persistence=0.7, frequency=16.0))
    seeds = np.asarray(jsx.seeds_from_key(key, b * c))
    monkeypatch.setattr(tnoise, "_seeds", lambda n, g: t64(seeds)[:n])
    sampler = tnoise.make_noise_sampler("simplex_2d", octaves=3, persistence=0.7,
                                        frequency=16.0, table=True)
    got = sampler((b, c, h, w), torch.tensor([1, 2]), torch.Generator())
    assert within(got.numpy(), want.transpose(0, 3, 1, 2)) >= SHARE


@pytest.mark.parametrize("share_batch", [False, True])
def test_table_sampler_matches_jax(monkeypatch, share_batch):
    """simplex_table=True: JAX's (sample, channel) layout of per-field
    table fields (share_batch: one per channel at t[0])."""
    key = jax.random.key(13)
    b, c, h, w = 2, 2, 16, 16
    t = np.array([5, 60], np.int32)
    n = c if share_batch else b * c
    t_fields = np.full(c, t[0]) if share_batch else np.repeat(t, c)
    fields, perms, gids = _jax_table_fields(key, (h, w), t_fields, n, 3)
    want = (np.broadcast_to(fields[None], (b, c, h, w)) if share_batch
            else fields.reshape(b, c, h, w))
    monkeypatch.setattr(tnoise, "_perms", lambda k, g: (t64(perms)[:k], t64(gids)[:k]))
    sampler = tnoise.make_noise_sampler("simplex", octaves=3,
                                        share_batch=share_batch, table=True)
    got = sampler((b, c, h, w), torch.from_numpy(t), torch.Generator())
    assert within(got.numpy(), want) >= SHARE


def test_simplex_volume_noise(monkeypatch):
    key = jax.random.key(0)
    want = np.asarray(jnoise.simplex_volume_noise(key, (6, 16, 16), octaves=4,
                                                  persistence=0.8, frequency=16.0))
    seed = np.asarray(jsx.seeds_from_key(key, 1))
    monkeypatch.setattr(tnoise, "_seeds", lambda n, g: t64(seed)[:n])
    got = tnoise.simplex_volume_noise((6, 16, 16), torch.Generator(), octaves=4,
                                      persistence=0.8, frequency=16.0)
    assert within(got, want) >= SHARE


def test_fingerprints_and_quirks():
    """Fingerprints are the JAX package's tuples; `table` is ignored for
    randParam and 2-D (anoddpm_tpu/ops/noise.py:171-179); unknown kinds
    fall through to simplex."""
    for kind in ("gauss", "simplex", "simplex_randParam", "simplex_2d",
                 "random", "anything"):
        for table in (False, True):
            kw = dict(octaves=3, persistence=0.7, frequency=32.0, table=table)
            j = jnoise.make_noise_sampler(kind, **kw).fingerprint
            assert tnoise.make_noise_sampler(kind, **kw).fingerprint == j
    gen = torch.Generator().manual_seed(0)
    for kind in ("simplex_randParam", "simplex_2d", "random"):
        out = tnoise.make_noise_sampler(kind, table=True)((1, 1, 8, 8),
                                                          torch.tensor([3]), gen)
        assert out.shape == (1, 1, 8, 8) and torch.isfinite(out).all()
