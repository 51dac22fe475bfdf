"""Kernel K2's plain version against the JAX package: the Pallas kernel in
interpret mode (fp32 and bf16) and flax GroupNorm32 + SiLU at shapes the TPU
kernel's eligibility gate refuses; and its gradient (the plain version of
K2b) against jax.vjp of the same functions."""
import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anoddpm_tpu.ops import pallas_norm
from anoddpm_torch.ops.group_norm_silu import (GroupNormSiLU, group_norm_silu,
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


def _port_vjp(x_nhwc, gamma, beta, cot_nhwc, dtype=torch.float32):
    """dx (NHWC, fp32 view), dgamma, dbeta of the port's differentiable
    group_norm_silu for the output cotangent `cot_nhwc`."""
    x = torch.from_numpy(np.ascontiguousarray(x_nhwc.transpose(0, 3, 1, 2)))
    x = x.to(dtype).requires_grad_()
    g = torch.from_numpy(gamma).requires_grad_()
    b = torch.from_numpy(beta).requires_grad_()
    out = group_norm_silu(x, g, b)
    cot = torch.from_numpy(np.ascontiguousarray(cot_nhwc.transpose(0, 3, 1, 2)))
    dx, dg, db = torch.autograd.grad(out, (x, g, b), cot.to(dtype))
    assert dx.dtype == dtype and dg.dtype == db.dtype == torch.float32
    return dx.float().numpy().transpose(0, 2, 3, 1), dg.numpy(), db.numpy()


def _jax_vjp(fn, x, gamma, beta, cot):
    out, vjp = jax.vjp(fn, x, jnp.asarray(gamma), jnp.asarray(beta))
    return [np.asarray(v.astype(jnp.float32)) for v in vjp(cot.astype(out.dtype))]


@pytest.mark.parametrize("shape", [(2, 8, 8, 128), (1, 4, 4, 256)])
def test_gradient_matches_pallas_kernel_fp32(shape):
    """dx, dgamma, dbeta against jax.vjp of the Pallas kernel (interpret
    mode) with its custom_vjp backward."""
    x, gamma, beta = _inputs(shape, seed=5)
    cot = np.random.default_rng(6).normal(size=shape).astype(np.float32)
    want = _jax_vjp(pallas_norm.group_norm_silu, jnp.asarray(x), gamma, beta,
                    jnp.asarray(cot))
    for got, w in zip(_port_vjp(x, gamma, beta, cot), want):
        np.testing.assert_allclose(got, w, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("shape", [(2, 8, 8, 128), (1, 4, 4, 256)])
def test_gradient_matches_pallas_kernel_bf16_within_one_ulp(shape):
    """bf16 x and cotangent: both sides compute the gradient in fp32 and
    round dx once to bf16, so dx agrees to one bf16 ulp (1e-5 floor);
    dgamma and dbeta stay fp32."""
    x, gamma, beta = _inputs(shape, seed=7)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    cot = jnp.asarray(np.random.default_rng(8).normal(size=shape)).astype(jnp.bfloat16)
    want = _jax_vjp(pallas_norm.group_norm_silu, xb, gamma, beta, cot)
    got = _port_vjp(np.asarray(xb.astype(jnp.float32)), gamma, beta,
                    np.asarray(cot.astype(jnp.float32)), torch.bfloat16)
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want[0]), 1e-30))) - 7)
    assert (np.abs(got[0] - want[0]) <= np.maximum(ulp, 1e-5)).all()
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g, w, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("c", [64, 96, 192])
def test_gradient_matches_flax_where_tpu_gate_refuses(c):
    shape = (2, 6, 5, c)
    x, gamma, beta = _inputs(shape, seed=c + 1)
    cot = np.random.default_rng(c).normal(size=shape).astype(np.float32)

    def flax_fn(xx, scale, bias):
        gn = nn.GroupNorm(num_groups=32, epsilon=1e-5, dtype=jnp.float32,
                          param_dtype=jnp.float32)
        return nn.silu(gn.apply({"params": {"scale": scale, "bias": bias}}, xx))
    want = _jax_vjp(flax_fn, jnp.asarray(x), gamma, beta, jnp.asarray(cot))
    for got, w in zip(_port_vjp(x, gamma, beta, cot), want):
        np.testing.assert_allclose(got, w, atol=1e-5, rtol=1e-5)


def test_plain_backward_passes_gradcheck():
    """The Function's plain forward and `_plain_backward` in float64 against
    finite differences."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((2, 64, 3, 4), generator=gen, dtype=torch.float64)
    gamma = 1 + 0.1 * torch.randn(64, generator=gen, dtype=torch.float64)
    beta = 0.1 * torch.randn(64, generator=gen, dtype=torch.float64)
    args = [t.requires_grad_() for t in (x, gamma, beta)]
    assert torch.autograd.gradcheck(
        lambda a, b, c: GroupNormSiLU.apply(a, b, c, 1e-5), args)


def test_no_grad_path_unchanged():
    """Without autograd the call is the plain forward itself; under
    autograd it goes through the Function with the same output."""
    x, gamma, beta = _inputs((2, 4, 4, 64), seed=9)
    xt = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))
    g, b = torch.from_numpy(gamma), torch.from_numpy(beta)
    with torch.no_grad():
        plain = group_norm_silu(xt, g, b)
    assert plain.grad_fn is None
    out = group_norm_silu(xt.clone().requires_grad_(), g, b)
    assert type(out.grad_fn).__name__ == "GroupNormSiLUBackward"
    torch.testing.assert_close(out.detach(), plain, atol=0, rtol=0)
