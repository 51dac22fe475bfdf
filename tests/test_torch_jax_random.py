"""`compat.jax_random` against `jax.random` on the CPU (JAX 0.9.0, its
default `jax_threefry_partitionable`).

key, split, fold_in, bits, uniform and randint are bit-equal.  normal and
truncated_normal go through `torch.special.erfinv` where XLA evaluates its
own polynomial: measured over 3 x 10^6 draws each, normal's values lie
within 91 ulps of JAX's (at |x| > 3.7, where both approximations are
steep; the 99.9th percentile is 9 ulps) and truncated_normal(-2, 2)'s
within 5 ulps of the value and 3 ulps of 1.0.  The bounds held here are
128 ulps and 8 ulps."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from anoddpm_torch.compat import jax_random as jr

NORMAL_ULPS = 128
TRUNCATED_ULPS = 8
SEEDS = st.one_of(st.sampled_from([0, 1, 2 ** 31 - 1]),
                  st.integers(0, 2 ** 31 - 1))
SHAPES = st.sampled_from([(), (1,), (7,), (2, 3), (4, 1, 5), (65537,)])


def words(k):
    return tuple(int(v) for v in np.asarray(jax.random.key_data(k)))


def u32(a):
    return np.asarray(a).astype(np.uint32).astype(np.int64)


def ulps(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


@settings(max_examples=25, deadline=None)
@given(seed=SEEDS, num=st.integers(1, 5),
       data=st.one_of(st.sampled_from([0, 1, 2 ** 31, 2 ** 32 - 1]),
                      st.integers(0, 2 ** 32 - 1)))
def test_key_split_fold_in_are_bit_equal(seed, num, data):
    k, K = jax.random.key(seed), jr.key(seed)
    assert K.words == words(k)
    assert [x.words for x in K.split(num)] == [words(x) for x in
                                              jax.random.split(k, num)]
    assert K.fold_in(data).words == words(jax.random.fold_in(k, data))
    with pytest.raises(OverflowError):
        K.fold_in(2 ** 32)


def test_split_and_draws_of_odd_and_even_sizes_bit_equal():
    """Split in 3, and bits and randint of odd and even sizes."""
    assert jax.config.jax_threefry_partitionable
    k, K = jax.random.key(11), jr.key(11)
    assert [x.words for x in K.split(3)] == [words(x) for x in
                                            jax.random.split(k, 3)]
    for shape in ((), (7,), (8,), (3, 5)):
        np.testing.assert_array_equal(jr.bits(K, shape).numpy(),
                                      u32(jax.random.bits(k, shape, jnp.uint32)))
        np.testing.assert_array_equal(jr.randint(K, shape, 0, 800).numpy(),
                                      np.asarray(jax.random.randint(k, shape, 0, 800)))


@settings(max_examples=20, deadline=None)
@given(seed=SEEDS, shape=SHAPES)
def test_bits_and_uniform_are_bit_equal(seed, shape):
    k, K = jax.random.key(seed), jr.key(seed)
    got = jr.bits(K, shape)
    assert tuple(got.shape) == shape
    np.testing.assert_array_equal(got.numpy(), u32(jax.random.bits(k, shape, jnp.uint32)))
    for lo, hi in ((0.0, 1.0), (-1.5, 2.25), (0.1, 0.3)):
        assert not ulps(jr.uniform(K, shape, lo, hi).numpy(),
                        jax.random.uniform(k, shape, minval=lo, maxval=hi)).any()


@settings(max_examples=20, deadline=None)
@given(seed=SEEDS, shape=SHAPES,
       span=st.sampled_from([(0, 800), (0, 1000), (0, 23), (-7, 5), (3, 3),
                             (0, 2 ** 31 - 1), (-2 ** 31, 2 ** 31 - 1)]))
def test_randint_is_bit_equal(seed, shape, span):
    k, K = jax.random.key(seed), jr.key(seed)
    got = jr.randint(K, shape, *span).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax.random.randint(k, shape, *span)))


@settings(max_examples=10, deadline=None)
@given(seed=SEEDS, shape=SHAPES)
def test_normal_and_truncated_normal_within_the_measured_ulps(seed, shape):
    k, K = jax.random.key(seed), jr.key(seed)
    assert ulps(jr.normal(K, shape).numpy(), jax.random.normal(k, shape)).max(
        initial=0) <= NORMAL_ULPS
    got = jr.truncated_normal(K, -2.0, 2.0, shape).numpy()
    want = np.asarray(jax.random.truncated_normal(k, -2.0, 2.0, shape))
    assert ulps(got, want).max(initial=0) <= TRUNCATED_ULPS
    assert (np.abs(got) < 2).all()


def test_draws_on_a_device_key_equal_the_host_draws():
    """A key's draws do not depend on where they are made: the numpy path
    of small host draws, the torch path of large ones."""
    K = jr.key(5)
    big = jr.bits(K, (jr._HOST_NUMPY + 3,))
    np.testing.assert_array_equal(big[:10].numpy(), jr.bits(K, (10,)).numpy())
    np.testing.assert_array_equal(big.numpy(), u32(jax.random.bits(
        jax.random.key(5), (jr._HOST_NUMPY + 3,), jnp.uint32)))
