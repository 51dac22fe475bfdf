"""The port's training objective and likelihood terms against the JAX
package: calc_loss (l2, l1, hybrid), calc_vlb_xt, prior_vlb and the full
calc_total_vlb sweep, on the tiny UNet with converted weights and injected
noise (the sweep's Gaussian draws are JAX's own, replayed from the same
key splits)."""
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

RTOL = 1e-5


@pytest.fixture(scope="module")
def setup():
    fmodel, params, port = flax_and_port(CONFIGS["s2d1"])
    rng = np.random.default_rng(11)
    x0 = np.clip(rng.normal(0, 0.5, (2, 32, 32, 1)), -1, 1).astype(np.float32)
    x0[0, :2] = -1.0            # pixels at the decoder's edge bins
    x0[1, -2:] = 1.0
    return (make_schedule(get_beta_schedule(T, "cosine")),
            ts.make_schedule(ts.get_beta_schedule(T, "cosine")),
            jax.jit(fmodel.apply), params, port, x0)


def _port_model(port):
    def model_fn(x, t):
        with torch.no_grad():
            return port(x, t)
    return model_fn


@pytest.mark.parametrize("loss_type", ["l2", "l1", "hybrid"])
def test_calc_loss_matches_jax(setup, loss_type):
    jsched, tsched, apply, params, port, x0 = setup
    jsamp, tsamp = bank_samplers(x0.shape)
    t = np.array([0, 13], np.int32)
    want, waux = jd.calc_loss(lambda x, tt: apply(params, x, tt), jsched,
                              jnp.asarray(x0), jnp.asarray(t),
                              jax.random.key(0), jsamp, loss_type)
    got, gaux = td.calc_loss(_port_model(port), tsched, nchw(x0),
                             torch.from_numpy(t.astype(np.int64)),
                             torch.Generator(), tsamp, loss_type)
    assert got.shape == (2,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL)
    np.testing.assert_allclose(nhwc(gaux["x_t"]), np.asarray(waux["x_t"]),
                               atol=1e-6)


def test_calc_vlb_xt_and_prior_match_jax(setup):
    """x_t drawn from q(x_t | x_0), as the sweep and the hybrid loss draw it
    (far from q's support the t = 0 decoder term takes the difference of
    two CDFs in the tanh tail, where each framework's tanh rounding is
    amplified by the cancellation)."""
    jsched, tsched, apply, params, port, x0 = setup
    rng = np.random.default_rng(12)
    t = np.array([0, 9], np.int32)
    xt = np.asarray(jd.sample_q(jsched, jnp.asarray(x0), jnp.asarray(t),
                                jnp.asarray(rng.normal(size=x0.shape),
                                            jnp.float32)))
    want, wx0 = jd.calc_vlb_xt(lambda x, tt: apply(params, x, tt), jsched,
                               jnp.asarray(x0), jnp.asarray(xt), jnp.asarray(t))
    got, gx0 = td.calc_vlb_xt(_port_model(port), tsched, nchw(x0), nchw(xt),
                              torch.from_numpy(t.astype(np.int64)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL)
    # pred_x_0 scales the UNet's ~3e-6 difference by sqrt(1 / alpha_bar - 1)
    np.testing.assert_allclose(nhwc(gx0), np.asarray(wx0), atol=1e-5)
    np.testing.assert_allclose(td.prior_vlb(tsched, nchw(x0)).numpy(),
                               np.asarray(jd.prior_vlb(jsched, jnp.asarray(x0))),
                               rtol=RTOL)


def test_likelihood_pieces_match_jax():
    rng = np.random.default_rng(13)
    a, b, c, d = (rng.normal(size=(3, 5)).astype(np.float32) for _ in range(4))
    np.testing.assert_allclose(
        td.normal_kl(*map(torch.from_numpy, (a, b, c, d))).numpy(),
        np.asarray(jd.normal_kl(*map(jnp.asarray, (a, b, c, d)))), rtol=RTOL)
    np.testing.assert_allclose(
        td.normal_kl(torch.from_numpy(a), torch.from_numpy(b), 0.0, 0.0).numpy(),
        np.asarray(jd.normal_kl(jnp.asarray(a), jnp.asarray(b), 0.0, 0.0)),
        rtol=RTOL)
    # means within a few scales of x, log scales of the decoder's range
    x = np.clip(a, -1, 1)
    x[0, 0], x[1, 1] = -1.0, 1.0
    log_scales = rng.uniform(-5, -2, x.shape).astype(np.float32)
    means = (x + np.exp(log_scales) * c).astype(np.float32)
    np.testing.assert_allclose(
        td.discretised_gaussian_log_likelihood(
            *map(torch.from_numpy, (x, means, log_scales))).numpy(),
        np.asarray(jd.discretised_gaussian_log_likelihood(
            *map(jnp.asarray, (x, means, log_scales)))), rtol=RTOL)


def test_calc_total_vlb_matches_jax(setup):
    """The T-step sweep with JAX's own Gaussian draws: the port replays the
    key splits of `jd.calc_total_vlb` as an injected sampler."""
    jsched, tsched, apply, params, port, x0 = setup
    key = jax.random.key(3)
    want = jax.jit(lambda x, k: jd.calc_total_vlb(
        lambda a, b: apply(params, a, b), jsched, x, k))(jnp.asarray(x0), key)
    bank, k = [], key
    for _ in range(T):
        k, sub = jax.random.split(k)
        bank.append(np.asarray(jax.random.normal(sub, x0.shape, jnp.float32)))
    tbank = nchw(np.stack(bank).reshape((-1,) + x0.shape[1:])).reshape(
        (T,) + (x0.shape[0], x0.shape[3]) + x0.shape[1:3])
    sampler = lambda shape, t, g: tbank[T - 1 - int(t[0])]
    got = td.calc_total_vlb(_port_model(port), tsched, nchw(x0),
                            torch.Generator(), sampler)
    assert got["vb"].shape == (2, T) and got["total_vlb"].shape == (2,)
    for name in ("total_vlb", "prior_vlb", "vb", "x_0_mse", "mse"):
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]),
                                   rtol=RTOL, atol=1e-7, err_msg=name)


def test_timestep_sampling():
    gen = torch.Generator().manual_seed(0)
    t = td.sample_timesteps(gen, 4096, 7)
    assert t.dtype == torch.int64 and int(t.min()) == 0 and int(t.max()) == 6
    table = td.make_loss_weights("prop-t", 10)
    np.testing.assert_array_equal(table.numpy(),
                                  np.asarray(jd.make_loss_weights("prop-t", 10)))
    assert td.make_loss_weights("none", 10) is None
    t, w = td.sample_t_with_weights(gen, 4096, table)
    p = table / table.sum()
    torch.testing.assert_close(w, 1.0 / (10 * p[t]))
    # the draw follows p: t = 0 is the likeliest, t = 9 the least likely
    counts = torch.bincount(t, minlength=10).float() / 4096
    assert (counts - p).abs().max() < 0.03
