"""The port's diffusion functions against the JAX package on the same
inputs and the same injected noise (threefry and Philox cannot agree, so
both sides read one numpy noise bank indexed by the timestep)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anoddpm_tpu import diffusion as jd
from anoddpm_tpu.schedule import get_beta_schedule, make_schedule
from anoddpm_torch import diffusion as td
from anoddpm_torch import schedule as ts
from torch_parity import CONFIGS, T, bank_samplers, flax_and_port, nchw, nhwc


@pytest.fixture(scope="module")
def scheds():
    return (make_schedule(get_beta_schedule(T, "cosine")),
            ts.make_schedule(ts.get_beta_schedule(T, "cosine")))


def test_sample_q_and_posterior_match_jax(scheds):
    jsched, tsched = scheds
    rng = np.random.default_rng(0)
    x0 = rng.uniform(-1, 1, (3, 8, 8, 1)).astype(np.float32)
    xt = rng.normal(size=x0.shape).astype(np.float32)
    noise = rng.normal(size=x0.shape).astype(np.float32)
    t = np.array([0, 7, T - 1], np.int32)
    want = jd.sample_q(jsched, jnp.asarray(x0), jnp.asarray(t), jnp.asarray(noise))
    got = td.sample_q(tsched, nchw(x0), torch.from_numpy(t.astype(np.int64)), nchw(noise))
    np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=1e-6)
    want = jd.q_posterior_mean_variance(jsched, jnp.asarray(x0), jnp.asarray(xt),
                                        jnp.asarray(t))
    got = td.q_posterior_mean_variance(tsched, nchw(x0), nchw(xt),
                                       torch.from_numpy(t.astype(np.int64)))
    np.testing.assert_allclose(nhwc(got[0]), np.asarray(want[0]), atol=1e-6)
    for w, g in zip(want[1:], got[1:]):
        np.testing.assert_array_equal(g.numpy().reshape(-1), np.asarray(w).reshape(-1))


def test_p_mean_variance_and_sample_p_match_jax(scheds):
    jsched, tsched = scheds
    rng = np.random.default_rng(1)
    xt = rng.normal(size=(2, 8, 8, 1)).astype(np.float32)
    noise = rng.normal(size=xt.shape).astype(np.float32)
    t = np.array([0, 11], np.int32)
    jmodel = lambda x, tt: 0.3 * x + 0.1
    tmodel = lambda x, tt: 0.3 * x + 0.1
    want = jd.p_mean_variance(jmodel, jsched, jnp.asarray(xt), jnp.asarray(t))
    got = td.p_mean_variance(tmodel, tsched, nchw(xt), torch.from_numpy(t.astype(np.int64)))
    np.testing.assert_allclose(nhwc(got.mean), np.asarray(want.mean), atol=1e-6)
    np.testing.assert_allclose(nhwc(got.pred_x_0), np.asarray(want.pred_x_0), atol=1e-6)
    np.testing.assert_array_equal(got.log_variance.numpy().reshape(-1),
                                  np.asarray(want.log_variance).reshape(-1))
    sample_w, _ = jd.sample_p(jmodel, jsched, jnp.asarray(xt), jnp.asarray(t),
                              jax.random.key(0), lambda k, s, tt: jnp.asarray(noise))
    sample_g, _ = td.sample_p(tmodel, tsched, nchw(xt),
                              torch.from_numpy(t.astype(np.int64)),
                              torch.Generator(), lambda s, tt, g: nchw(noise))
    np.testing.assert_allclose(nhwc(sample_g), np.asarray(sample_w), atol=1e-6)
    # noise is zeroed at t == 0
    np.testing.assert_allclose(nhwc(sample_g)[0], nhwc(got.mean)[0], atol=0)


def test_forward_backward_matches_jax(scheds):
    """The tiny UNet, cosine T = 20, lambda = 10: the whole partial-diffusion
    chain agrees with JAX to 2e-4."""
    jsched, tsched = scheds
    fmodel, params, port = flax_and_port(CONFIGS["s2d1"])
    x = np.random.default_rng(3).uniform(-1, 1, (2, 32, 32, 1)).astype(np.float32)
    jsamp, tsamp = bank_samplers(x.shape)
    want, _ = jax.jit(lambda xx: jd.forward_backward(
        lambda a, b: fmodel.apply(params, a, b), jsched, xx, 10,
        jax.random.key(0), noise_sampler=jsamp))(jnp.asarray(x))
    with torch.no_grad():
        got = td.forward_backward(port, tsched, nchw(x), 10, torch.Generator(),
                                  noise_sampler=tsamp)
    np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=2e-4)
    assert td.forward_backward(port, tsched, nchw(x), 0, None) is not None
