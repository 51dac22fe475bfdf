"""Kernel K2's plain version against the JAX package: the Pallas kernel in
interpret mode (fp32 and bf16) and flax GroupNorm32 + SiLU at shapes the TPU
kernel's eligibility gate refuses."""
import flax.linen as nn
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anoddpm_tpu.ops import pallas_norm
from anoddpm_torch.ops.group_norm_silu import (group_norm_silu,
                                               group_norm_silu_with_stats)


def _inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(0.3, 1.5, size=shape).astype(np.float32)
    gamma = rng.normal(1.0, 0.1, shape[-1]).astype(np.float32)
    beta = rng.normal(0.0, 0.1, shape[-1]).astype(np.float32)
    return x, gamma, beta


def _port(x_nhwc, gamma, beta, dtype=torch.float32):
    x = torch.from_numpy(np.ascontiguousarray(x_nhwc.transpose(0, 3, 1, 2)))
    out = group_norm_silu(x.to(dtype), torch.from_numpy(gamma),
                          torch.from_numpy(beta))
    assert out.dtype == dtype
    return out.float().numpy().transpose(0, 2, 3, 1)


@pytest.mark.parametrize("shape", [(2, 8, 8, 128), (1, 4, 4, 256)])
def test_matches_pallas_kernel_fp32(shape):
    x, gamma, beta = _inputs(shape)
    want = np.asarray(pallas_norm.group_norm_silu(
        jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta)))
    np.testing.assert_allclose(_port(x, gamma, beta), want, atol=1e-5, rtol=1e-5)


def test_stats_match_pallas_kernel():
    x, gamma, beta = _inputs((2, 8, 8, 128), seed=3)
    _, mean, rstd = pallas_norm._fused_call(jnp.asarray(x), jnp.asarray(gamma),
                                            jnp.asarray(beta), 1e-5)
    xt = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))
    _, m, r = group_norm_silu_with_stats(xt, torch.from_numpy(gamma),
                                         torch.from_numpy(beta))
    assert m.shape == r.shape == (2, 32)
    np.testing.assert_allclose(m.numpy(), np.asarray(mean)[:, 0], atol=1e-6)
    np.testing.assert_allclose(r.numpy(), np.asarray(rstd)[:, 0], rtol=1e-5)


@pytest.mark.parametrize("shape", [(2, 8, 8, 128), (1, 4, 4, 256)])
def test_matches_pallas_kernel_bf16_within_one_ulp(shape):
    """Both sides compute in fp32 and round once to bf16, so they agree to
    one bf16 ulp of the value (2^-8 relative), with the fp32 tolerance as a
    floor next to zero."""
    x, gamma, beta = _inputs(shape, seed=1)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    want = np.asarray(pallas_norm.group_norm_silu(
        xb, jnp.asarray(gamma), jnp.asarray(beta)).astype(jnp.float32))
    got = _port(np.asarray(xb.astype(jnp.float32)), gamma, beta, torch.bfloat16)
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    assert (np.abs(got - want) <= np.maximum(ulp, 1e-5)).all()


@pytest.mark.parametrize("c", [64, 96, 192])
def test_matches_flax_where_tpu_gate_refuses(c):
    shape = (2, 6, 5, c)
    assert not pallas_norm.eligible(shape, jnp.float32)
    x, gamma, beta = _inputs(shape, seed=c)
    gn = nn.GroupNorm(num_groups=32, epsilon=1e-5, dtype=jnp.float32,
                      param_dtype=jnp.float32)
    want = nn.silu(gn.apply({"params": {"scale": jnp.asarray(gamma),
                                        "bias": jnp.asarray(beta)}},
                            jnp.asarray(x)))
    np.testing.assert_allclose(_port(x, gamma, beta), np.asarray(want),
                               atol=1e-5, rtol=1e-5)


def test_rejects_bad_shapes():
    with pytest.raises(ValueError):
        group_norm_silu(torch.zeros(1, 48, 2, 2), torch.ones(48), torch.zeros(48))
    with pytest.raises(ValueError):
        group_norm_silu(torch.zeros(1, 64, 2, 2), torch.ones(32), torch.zeros(32))
