"""remat and the multi-step of the port's training against the JAX package.

- remat None, "dots" and "nothing": one train step from the same
  parameters, t and noise gives the same loss and gradients within 1e-6
  relative (the recompute reruns the same operations), and each equals the
  JAX step with its own `remat` (loss and grad norm within 1e-5 relative,
  gradients at the train step's rule: atol 1e-6, rtol 1e-4).
- `make_multi_step` at S = 2 equals two single steps with the same draws
  (bit for bit), and its mean loss and grad norm equal JAX's
  `make_multi_step` on the same batches, t and noise within 1e-5.

t is JAX's own draw, handed to the port; the noise comes from one numpy
bank on both sides."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anoddpm_tpu import diffusion as jd
from anoddpm_tpu import training as jtr
from anoddpm_tpu.schedule import get_beta_schedule, make_schedule
from anoddpm_torch import schedule as ts
from anoddpm_torch import training as ttr
from anoddpm_torch.compat.flax_params import unet_state_dict_from_flax
from anoddpm_torch.models.unet import UNet
from torch_parity import CONFIGS, T, bank_samplers, flax_and_port, nchw

LR = 1e-4
MAX_T = 12
BATCH = 2
CFG = CONFIGS["s2d1"]


def jax_t(key, step):
    """The t that `anoddpm_tpu.training.make_train_step` draws at `step`."""
    t_key, _, _ = jax.random.split(jax.random.fold_in(key, step), 3)
    return np.asarray(jd.sample_timesteps(t_key, BATCH, MAX_T))


def batch(seed):
    return np.random.default_rng(seed).normal(
        size=(BATCH, 32, 32, 1)).astype(np.float32)


@pytest.fixture(scope="module")
def setup():
    fmodel, params, _ = flax_and_port(CFG)
    jsamp, tsamp = bank_samplers((BATCH, 32, 32, 1))
    return fmodel, params, jsamp, tsamp


def port_state(params):
    model = UNet(**CFG)
    model.load_state_dict(unet_state_dict_from_flax(params))
    return ttr.init_train_state(model, ttr.make_optimizer(model.parameters(), LR))


def port_step(tsamp, remat=None):
    sched = ts.make_schedule(ts.get_beta_schedule(T, "cosine"))
    return ttr.make_train_step(sched, tsamp, "l2", max_t=MAX_T, remat=remat)


def flat_grads(model):
    return {n: p.grad.detach().clone() for n, p in model.named_parameters()}


@pytest.fixture(scope="module")
def port_runs(setup):
    """One step under each remat policy: (metrics, clipped gradients)."""
    _, params, _, tsamp = setup
    t = torch.from_numpy(jax_t(jax.random.key(7), 0).astype(np.int64))
    out = {}
    for remat in (None, "dots", "nothing"):
        state = port_state(params)
        m = port_step(tsamp, remat)(state, nchw(batch(0)), torch.Generator(), t=t)
        out[remat] = ({k: float(v) for k, v in m.items()},
                      flat_grads(state.model))
    return out


@pytest.mark.parametrize("remat", ["dots", "nothing"])
def test_remat_equals_no_remat(port_runs, remat):
    (m0, g0), (m1, g1) = port_runs[None], port_runs[remat]
    for k in m0:
        np.testing.assert_allclose(m1[k], m0[k], rtol=1e-6)
    for n in g0:
        np.testing.assert_allclose(g1[n].numpy(), g0[n].numpy(), rtol=1e-6,
                                   atol=1e-6 * float(g0[n].abs().max()),
                                   err_msg=n)


@pytest.mark.parametrize("remat", [None, "dots", "nothing"])
def test_remat_step_matches_jax(setup, port_runs, remat):
    fmodel, params, jsamp, _ = setup
    jsched = make_schedule(get_beta_schedule(T, "cosine"))
    tx = jtr.make_optimizer(LR, 0.0, 1.0)
    step = jax.jit(jtr.make_train_step(fmodel, jsched, tx, jsamp, "l2",
                                       max_t=MAX_T, remat=remat))
    state = jtr.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                           ema_params=params, opt_state=tx.init(params))
    _, want = step(state, jnp.asarray(batch(0)), jax.random.key(7))
    got, grads = port_runs[remat]
    np.testing.assert_allclose(got["loss"], float(want["loss"]), rtol=1e-5)
    np.testing.assert_allclose(got["grad_norm"], float(want["grad_norm"]),
                               rtol=1e-5)
    # the JAX gradients under the same policy, clipped by optax's factor
    policy = {None: None, "dots": jax.checkpoint_policies.dots_saveable,
              "nothing": jax.checkpoint_policies.nothing_saveable}[remat]
    t = jnp.asarray(jax_t(jax.random.key(7), 0))

    def loss_fn(p):
        mf = lambda a, b: fmodel.apply(p, a, b)
        if policy is not None:
            mf = jax.checkpoint(mf, policy=policy)
        per, _ = jd.calc_loss(mf, jsched, jnp.asarray(batch(0)), t,
                              jax.random.key(0), jsamp)
        return jnp.mean(per)

    jgrads = unet_state_dict_from_flax(jax.tree_util.tree_map(
        np.asarray, jax.jit(jax.grad(loss_fn))(params)))
    clip = max(float(want["grad_norm"]), 1.0)
    for n, g in grads.items():
        np.testing.assert_allclose(g.numpy(), jgrads[n].numpy() / clip,
                                   atol=1e-6, rtol=1e-4, err_msg=n)


def test_remat_rejects_unknown_policy(setup):
    with pytest.raises(ValueError, match="remat"):
        port_step(setup[3], "everything")


def test_multi_step_equals_single_steps(setup):
    """S = 2 on a (2, B, ...) batch: the same parameters, EMA and metrics
    as two single steps drawing t and noise from one generator."""
    _, params, _, _ = setup
    from anoddpm_torch.ops.noise import make_noise_sampler
    sched = ts.make_schedule(ts.get_beta_schedule(T, "cosine"))
    # a step serves one model: one closure for each state
    single = lambda: ttr.make_train_step(sched, make_noise_sampler("simplex"),
                                         "l2", max_t=MAX_T)
    multi, single = ttr.make_multi_step(single(), 2), single()
    xs = torch.stack([nchw(batch(0)), nchw(batch(1))])
    a, b = port_state(params), port_state(params)
    ga, gb = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    m = multi(a, xs, ga)
    ms = [single(b, xs[s], gb) for s in range(2)]
    assert a.step == b.step == 2 and m["loss"].shape == ()
    assert float(m["loss"]) == float(torch.stack([x["loss"] for x in ms]).mean())
    assert float(m["grad_norm"]) == float(
        torch.stack([x["grad_norm"] for x in ms]).mean())
    for (n, p), q in zip(a.model.named_parameters(), b.model.parameters()):
        assert torch.equal(p, q), n
    for p, q in zip(a.ema.parameters(), b.ema.parameters()):
        assert torch.equal(p, q)
    with pytest.raises(ValueError):
        multi(a, xs[:1], ga)


def test_train_step_serves_one_model(setup):
    """The step builds its module (remat, DDP) for the first model it
    is given and refuses another."""
    _, params, _, tsamp = setup
    step = port_step(tsamp, "nothing")
    gen = torch.Generator().manual_seed(5)
    step(port_state(params), nchw(batch(0)), gen)
    with pytest.raises(ValueError, match="another model"):
        step(port_state(params), nchw(batch(0)), gen)


def test_multi_step_matches_jax(setup):
    fmodel, params, jsamp, tsamp = setup
    jsched = make_schedule(get_beta_schedule(T, "cosine"))
    tx = jtr.make_optimizer(LR, 0.0, 1.0)
    base = jtr.make_train_step(fmodel, jsched, tx, jsamp, "l2", max_t=MAX_T)
    multi = jax.jit(jtr.make_multi_step(base, 2))
    xs = np.stack([batch(0), batch(1)])
    key = jax.random.key(9)
    state = jtr.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                           ema_params=params, opt_state=tx.init(params))
    _, want = multi(state, jnp.asarray(xs), key)
    # the t of each substep: the scan splits the key, the step folds in
    # its counter
    ts_ = []
    k = key
    for s in range(2):
        k, sub = jax.random.split(k)
        ts_.append(jax_t(sub, s))
    t = torch.from_numpy(np.stack(ts_).astype(np.int64))
    pmulti = ttr.make_multi_step(port_step(tsamp), 2)
    got = pmulti(port_state(params), torch.stack([nchw(x) for x in xs]),
                 torch.Generator(), t=t)
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(got["grad_norm"]), float(want["grad_norm"]),
                               rtol=1e-5)
