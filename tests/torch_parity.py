"""Shared helpers of the port's parity tests (tests/test_torch_*.py): small
UNet configurations, flax parameters with their conversion, NHWC <-> NCHW,
and a numpy noise bank that both frameworks read."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from anoddpm_tpu.models.unet import UNet as FlaxUNet
from anoddpm_torch.compat.flax_params import unet_state_dict_from_flax
from anoddpm_torch.models.unet import UNet

T = 20  # the cosine schedule length of the chain tests

# The suite runs as several worker processes on one machine (pytest-xdist,
# and every worker imports this module while collecting).  Torch's default
# of one intra-op thread per core in each of them oversubscribes the cores,
# and its parallel regions then wait on descheduled threads: with 4 workers
# on 8 cores the port's tests ran for over 17 minutes and were stopped at
# 91%, and took 100 s with one thread per worker.
torch.set_num_threads(1)


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def nhwc(t):
    return t.numpy().transpose(0, 2, 3, 1)


CONFIGS = {
    "s2d1": dict(img_size=32, base_channels=32, channel_mults=(1, 2),
                 attention_resolutions="16"),
    "s2d2": dict(img_size=32, base_channels=32, channel_mults=(1, 2),
                 attention_resolutions="16", space_to_depth=2),
    # base 128 at 16^2 passes the TPU gate, so flax names the norm+SiLU
    # params {name}_pscale/_pbias
    "pallas": dict(img_size=16, base_channels=128, channel_mults=(1,),
                   attention_resolutions="16", pallas_norm=True),
}


def flax_and_port(cfg, seed=0):
    """Flax params perturbed to non-zero values, and the port model loaded
    with their conversion."""
    img = cfg["img_size"]
    fmodel = FlaxUNet(**cfg)
    params = jax.jit(fmodel.init)(jax.random.key(seed),
                                  jnp.zeros((1, img, img, 1)),
                                  jnp.zeros((1,), jnp.int32))
    rng = np.random.default_rng(seed + 5)
    params = jax.tree_util.tree_map(
        lambda p: np.asarray(p) + rng.normal(0, 0.05, p.shape).astype(np.float32),
        params)
    port = UNet(**{k: v for k, v in cfg.items() if k != "pallas_norm"})
    port.load_state_dict(unet_state_dict_from_flax(params), strict=True)
    return fmodel, params, port.eval()


def port_apply(port, x_nhwc, t):
    with torch.no_grad():
        return nhwc(port(nchw(x_nhwc), torch.from_numpy(np.asarray(t, np.int64))))


def bank_samplers(shape_nhwc, seed=2):
    """One numpy noise field per timestep, as a JAX sampler and its twin."""
    bank = np.random.default_rng(seed).normal(
        size=(T,) + shape_nhwc).astype(np.float32)
    jbank = jnp.asarray(bank)
    tbank = torch.from_numpy(np.ascontiguousarray(bank.transpose(0, 1, 4, 2, 3)))
    return (lambda k, s, t: jbank[t[0]]), (lambda s, t, g: tbank[t[0]])


def per_sample_bank_samplers(shape_nhwc, seed=2, steps=T):
    """A numpy noise bank of `steps` timesteps by B samples, as a JAX sampler
    and its twin that both give sample i at timestep t[i] the field
    bank[t[i], i], so that per-sample timesteps (the batched-lambda chain's
    q-jump) read the same noise on both sides; at a uniform t this is
    `bank_samplers` with one field per sample."""
    bank = np.random.default_rng(seed).normal(
        size=(steps,) + tuple(shape_nhwc)).astype(np.float32)
    jbank = jnp.asarray(bank)
    tbank = torch.from_numpy(np.ascontiguousarray(bank.transpose(0, 1, 4, 2, 3)))

    def jax_sampler(key, shape, t):
        return jbank[t, jnp.arange(shape[0])]

    def torch_sampler(shape, t, generator):
        t = t.cpu()
        return tbank[t, torch.arange(shape[0])].to(generator.device)

    return jax_sampler, torch_sampler
