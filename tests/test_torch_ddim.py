"""The rest of the port's diffusion against the JAX package, in fp32 with
the noise injected on both sides (`tests/torch_parity.py`): DDIM (its
timesteps, one step, the chain, the partial forward-backward with frame
capture), the gradual forward step and chain, the "half"/"whole" frame
capture of forward_backward, the batched-lambda chain, and the headline
metrics with sampler=ddim.  Tolerances: x and frames within 2e-4 through
the tiny UNet (1e-6 where no UNet runs), timesteps exactly, the metrics
within 1e-4."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anoddpm_tpu import detect as jdetect
from anoddpm_tpu import diffusion as jd
from anoddpm_tpu.config import defaultdict_from_json
from anoddpm_tpu.schedule import get_beta_schedule, make_schedule
from anoddpm_tpu.training import EvalModel
from anoddpm_torch import detect as tdetect
from anoddpm_torch import diffusion as td
from anoddpm_torch import schedule as ts
from torch_parity import (CONFIGS, T, flax_and_port, nchw, nhwc,
                          per_sample_bank_samplers)

ATOL = 2e-4


@pytest.fixture(scope="module")
def scheds():
    return (make_schedule(get_beta_schedule(T, "cosine")),
            ts.make_schedule(ts.get_beta_schedule(T, "cosine")))


@pytest.fixture(scope="module")
def models():
    fmodel, params, port = flax_and_port(CONFIGS["s2d1"])
    return (lambda a, b: fmodel.apply(params, a, b)), port, (fmodel, params)


def images(b=2, seed=3):
    return np.random.default_rng(seed).uniform(-1, 1, (b, 32, 32, 1)).astype(np.float32)


@pytest.mark.parametrize("lo,hi", [(1, 100), (100, 400), (400, 1001)])
def test_ddim_timesteps_equal_jax(lo, hi):
    """A spread of t_distance in [lo, hi) at a spread of step counts,
    exactly: the fp32 grid lands on the same side of every half as XLA's
    (exact arithmetic rounds (14, 11) and (15, 13) otherwise)."""
    spread = list(range(lo, hi, 3 if hi <= 100 else 19))
    for t_distance in spread + [t for t in (14, 15, 200) if lo <= t < hi]:
        for steps in (0, 1, 2, 5, 11, 13, 15, 25, 100, 1000):
            want = np.asarray(jd.ddim_timesteps(t_distance, steps))
            got = td.ddim_timesteps(t_distance, steps).numpy()
            assert got.dtype == np.int64
            np.testing.assert_array_equal(got, want, err_msg=f"{t_distance}, {steps}")


U = 2.0 ** -24          # fp32's unit roundoff
C_ROUNDINGS = 18        # c's roundings on the two sides (9 each, below)
ILL = 2.0 ** 10         # c's cancellation ratio from which c is ill-conditioned


def ddim_c_conditioning(acp, x, eps, t, t_prev, eta):
    """Per element of one DDIM step: (the bound that c = 1 - a_prev -
    sigma^2's rounding puts on x_prev, whether c is well conditioned), in
    float64 from the same fp32 alphas_cumprod `acp` and inputs."""
    shape = (-1,) + (1,) * (x.ndim - 1)
    acp = np.asarray(acp, np.float64)
    a_t = acp[t].reshape(shape)
    a_prev = np.where(t_prev < 0, 1.0, acp[np.maximum(t_prev, 0)]).reshape(shape)
    x, eps = x.astype(np.float64), eps.astype(np.float64)
    x0 = np.clip((x - np.sqrt(1 - a_t) * eps) / np.sqrt(a_t), -1, 1)
    eps_hat = (x - np.sqrt(a_t) * x0) / np.sqrt(1 - a_t)
    sigma2 = eta ** 2 * (1 - a_prev) / (1 - a_t) * (1 - a_t / a_prev)
    terms = (1 - a_prev) + sigma2
    c = np.maximum((1 - a_prev) - sigma2, 0.0)
    dc = C_ROUNDINGS * U * terms
    with np.errstate(divide="ignore", invalid="ignore"):
        bound = np.abs(eps_hat) * np.where(
            dc > 0, np.minimum(dc / (2 * np.sqrt(c)), np.sqrt(dc)), 0.0)
        well = (terms == 0) | (terms < ILL * c)
    return bound, np.broadcast_to(well, x.shape)


@pytest.mark.parametrize("eta", [0.0, 1.0])
def test_ddim_step_matches_jax(scheds, eta):
    """x_prev = sqrt(a_prev) x0 + sqrt(c) eps_hat + sigma z, with c = 1 -
    a_prev - sigma^2.  Each side rounds 1 - a_prev once (<= u (1 - a_prev))
    and sigma^2 after nine roundings (1 - a_prev, 1 - a_t, their quotient,
    its sqrt, a_t / a_prev, 1 - it, its sqrt, the product, the square; <= 9u
    sigma^2 to first order), so the two sides' c lie within dc = 18u (1 -
    a_prev + sigma^2) of each other, u = 2^-24; sqrt carries dc to
    |eps_hat| min(dc / (2 sqrt c), sqrt dc).  At eta 1 sample 0 (t 19 -> 12)
    has c = 1.2e-5 against 1 - a_prev + sigma^2 = 1.3: the bound is ~2e-4
    |eps_hat| there.  Against a float64 evaluation from the same fp32
    alphas_cumprod, sample 0's x_prev is off by 2.9e-5 in JAX eager, 1.9e-5
    in JAX jit, 1.7e-5 in the port (eager and jit differ by 1.0e-5).  So
    x_prev is held within 1e-6 plus that bound, and within 1e-6 alone where
    c is well conditioned (1 - a_prev + sigma^2 < 2^10 c, or both 0 at the
    terminal step): samples 1 and 2, and every sample at eta 0.  pred_x0
    has no such term: 1e-6."""
    jsched, tsched = scheds
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, 8, 8, 1)).astype(np.float32)
    eps = rng.normal(size=x.shape).astype(np.float32)
    noise = rng.normal(size=x.shape).astype(np.float32)
    t = np.array([19, 9, 4])
    t_prev = np.array([12, 3, -1])       # -1: the terminal step to x_0
    want = jd.ddim_step(jsched, jnp.asarray(x), jnp.asarray(t, jnp.int32),
                        jnp.asarray(t_prev, jnp.int32), jnp.asarray(eps), eta,
                        jnp.asarray(noise) if eta else None)
    got = td.ddim_step(tsched, nchw(x), torch.from_numpy(t),
                       torch.from_numpy(t_prev), nchw(eps), eta,
                       nchw(noise) if eta else None)
    bound, well = ddim_c_conditioning(tsched.alphas_cumprod.numpy(), x, eps,
                                      t, t_prev, eta)
    assert well[1:].all() and (eta == 1.0) == (not well[0].any())
    d = np.abs(nhwc(got[0]).astype(np.float64) - np.asarray(want[0]))
    assert (d <= 1e-6 + bound).all(), (d - bound).max()
    assert (d[well] <= 1e-6).all(), d[well].max()
    np.testing.assert_allclose(nhwc(got[1]), np.asarray(want[1]), atol=1e-6)


@pytest.mark.parametrize("eta", [0.0, 1.0])
def test_forward_backward_ddim_matches_jax(scheds, models, eta):
    """The q-jump and 4 strided steps of lambda = 12 through the tiny UNet:
    x_recon and the captured frames [x_t, every step]."""
    jsched, tsched = scheds
    jmodel, port, _ = models
    x = images()
    jsamp, tsamp = per_sample_bank_samplers(x.shape)
    want, wframes = jax.jit(lambda xx: jd.forward_backward_ddim(
        jmodel, jsched, xx, 12, 4, jax.random.key(0), noise_sampler=jsamp,
        eta=eta, see_whole_sequence="half"))(jnp.asarray(x))
    frames = []
    with torch.no_grad():
        got = td.forward_backward_ddim(port, tsched, nchw(x), 12, 4,
                                       torch.Generator(), noise_sampler=tsamp,
                                       eta=eta, frames=frames)
        plain = td.forward_backward_ddim(port, tsched, nchw(x), 12, 4,
                                         torch.Generator(), noise_sampler=tsamp,
                                         eta=eta)
    np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=ATOL)
    assert torch.equal(got, plain)
    assert len(frames) == 5 and torch.equal(frames[-1], got)
    np.testing.assert_allclose(torch.stack(frames).numpy().transpose(0, 1, 3, 4, 2),
                               np.asarray(wframes), atol=ATOL)


def test_ddim_eta0_draws_no_noise(scheds, models):
    _, tsched = scheds
    _, port, _ = models
    calls = []

    def counting(shape, t, g):
        calls.append(int(t[0]))
        return torch.zeros(shape)
    with torch.no_grad():
        a = td.ddim_chain(port, tsched, nchw(images()), 12, 4, torch.Generator(),
                          noise_sampler=counting)
        b = td.ddim_chain(port, tsched, nchw(images()), 12, 4, torch.Generator(),
                          noise_sampler=counting)
    assert calls == [] and torch.equal(a, b)
    with torch.no_grad():
        td.ddim_chain(port, tsched, nchw(images()), 12, 4, torch.Generator(),
                      eta=1.0, noise_sampler=counting)
    assert calls == td.ddim_timesteps(12, 4).tolist()


def test_sample_q_gradual_and_gradual_chain_match_jax(scheds):
    jsched, tsched = scheds
    x = images(3)
    jsamp, tsamp = per_sample_bank_samplers(x.shape)
    t = np.array([0, 7, T - 1])
    noise = np.random.default_rng(5).normal(size=x.shape).astype(np.float32)
    want = jd.sample_q_gradual(jsched, jnp.asarray(x), jnp.asarray(t, jnp.int32),
                               jnp.asarray(noise))
    got = td.sample_q_gradual(tsched, nchw(x), torch.from_numpy(t), nchw(noise))
    np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=1e-6)
    want, wframes = jd.diffuse_gradual_chain(jsched, jnp.asarray(x), 9,
                                             jax.random.key(0), jsamp)
    frames = []
    got = td.diffuse_gradual_chain(tsched, nchw(x), 9, torch.Generator(), tsamp,
                                   frames)
    np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=1e-6)
    np.testing.assert_allclose(torch.stack(frames).numpy().transpose(0, 1, 3, 4, 2),
                               np.asarray(wframes), atol=1e-6)


@pytest.mark.parametrize("mode", ["half", "whole"])
def test_forward_backward_sequence_matches_jax(scheds, models, mode):
    """x_recon and the frames of see_whole_sequence "half" ([x_lambda, the
    reverse chain]) and "whole" ([the forward chain, the reverse chain])."""
    jsched, tsched = scheds
    jmodel, port, _ = models
    x = images()
    jsamp, tsamp = per_sample_bank_samplers(x.shape)
    want, wframes = jax.jit(lambda xx: jd.forward_backward(
        jmodel, jsched, xx, 6, jax.random.key(0), noise_sampler=jsamp,
        see_whole_sequence=mode))(jnp.asarray(x))
    with torch.no_grad():
        got, frames = td.forward_backward_sequence(
            port, tsched, nchw(x), 6, torch.Generator(), noise_sampler=tsamp,
            see_whole_sequence=mode)
    assert frames.shape == ((1 if mode == "half" else 6) + 6, 2, 1, 32, 32)
    np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=ATOL)
    np.testing.assert_allclose(frames.numpy().transpose(0, 1, 3, 4, 2),
                               np.asarray(wframes), atol=ATOL)
    assert td.forward_backward_sequence(port, tsched, nchw(x), 0, None)[1] is None
    with pytest.raises(ValueError):
        td.forward_backward_sequence(port, tsched, nchw(x), 6, None,
                                     see_whole_sequence="all")


def test_gradual_forward_matches_jax(scheds, models):
    jsched, tsched = scheds
    jmodel, port, _ = models
    x = images()
    jsamp, tsamp = per_sample_bank_samplers(x.shape)
    want, none = jax.jit(lambda xx: jd.forward_backward(
        jmodel, jsched, xx, 5, jax.random.key(0), noise_sampler=jsamp,
        gradual_forward=True))(jnp.asarray(x))
    assert none is None
    with torch.no_grad():
        got = td.forward_backward(port, tsched, nchw(x), 5, torch.Generator(),
                                  noise_sampler=tsamp, gradual_forward=True)
    np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=ATOL)


def test_batched_lambda_matches_jax(scheds, models):
    """Mixed lambdas, one of them 0 (returned unchanged), against JAX; and
    with every lambda = max_t the very tensor of forward_backward."""
    jsched, tsched = scheds
    jmodel, port, _ = models
    x = images(4)
    lam = np.array([0, 3, 8, 5])
    jsamp, tsamp = per_sample_bank_samplers(x.shape)
    want = jax.jit(lambda xx, ll: jd.forward_backward_batched_lambda(
        jmodel, jsched, xx, ll, 8, jax.random.key(0), noise_sampler=jsamp))(
        jnp.asarray(x), jnp.asarray(lam, jnp.int32))
    with torch.no_grad():
        got = td.forward_backward_batched_lambda(
            port, tsched, nchw(x), torch.from_numpy(lam), 8, torch.Generator(),
            noise_sampler=tsamp)
    np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=ATOL)
    np.testing.assert_array_equal(nhwc(got)[0], x[0])
    with torch.no_grad():
        full = td.forward_backward_batched_lambda(
            port, tsched, nchw(x), torch.full((4,), 8), 8, torch.Generator(),
            noise_sampler=tsamp)
        fb = td.forward_backward(port, tsched, nchw(x), 8, torch.Generator(),
                                 noise_sampler=tsamp)
    assert torch.equal(full, fb)


def test_batched_lambda_with_a_generator_equals_forward_backward(scheds, models):
    """The draw order: from one generator seed, a chunk at lambda = max_t
    gives forward_backward's tensor with simplex noise drawn, not
    injected."""
    from anoddpm_torch.ops.noise import make_noise_sampler
    _, tsched = scheds
    _, port, _ = models
    x = nchw(images(2))
    sampler = make_noise_sampler("simplex")
    with torch.no_grad():
        a = td.forward_backward_batched_lambda(
            port, tsched, x, torch.full((2,), 4), 4,
            torch.Generator().manual_seed(7), noise_sampler=sampler)
        b = td.forward_backward(port, tsched, x, 4,
                                torch.Generator().manual_seed(7),
                                noise_sampler=sampler)
    assert torch.equal(a, b)


ARGS = {"img_size": [32, 32], "T": T, "beta_schedule": "cosine",
        "base_channels": 32, "channel_mults": "1 2",
        "attention_resolutions": "16", "noise_fn": "simplex",
        "dataset": "synthetic", "compute_dtype": "float32",
        "anomalous_volumes": 1, "sampler": "ddim", "ddim_steps": 5}


@pytest.mark.parametrize("eta", [0.0, 1.0])
def test_ddim_headline_metrics_match_jax(scheds, models, monkeypatch, tmp_path, eta):
    """anomalous_metric_calculation with sampler=ddim (lambda clamped to
    T = 20, 5 steps) on one synthetic volume: the seven metrics within
    1e-4 of the JAX package's."""
    jsched, tsched = scheds
    _, port, (fmodel, params) = models
    jsamp, tsamp = per_sample_bank_samplers((4, 32, 32, 1))
    monkeypatch.setattr(jdetect, "sampler_from_args", lambda a: jsamp)
    monkeypatch.setattr(tdetect, "sampler_from_args", lambda a: tsamp)
    args = {**ARGS, "arg_num": "ddim", "ddim_eta": eta}
    want = jdetect.anomalous_metric_calculation(
        defaultdict_from_json(args), root_dir=str(tmp_path / "jax"),
        em=EvalModel(fmodel, params), sched=jsched)
    got = tdetect.anomalous_metric_calculation(
        defaultdict_from_json(args), root_dir=str(tmp_path / "port"), em=port,
        sched=tsched, device="cpu")
    for k in tdetect.METRIC_NAMES:
        assert abs(got[k] - want[k]) <= 1e-4, (k, got[k], want[k])
    assert ((tmp_path / "port" / "metrics" / "argsddim.csv").read_text()
            .splitlines()[0] == "dice,ssim,iou,precision,recall,fpr,auc")
