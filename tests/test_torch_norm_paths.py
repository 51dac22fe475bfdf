"""The port's flax-order norm path (`norm_impl="flax"`) against the JAX
package's own composition: flax's GroupNorm32 (with and without
`bf16_path`) followed by `nn.silu`, at one site and through the UNet, and
the Pallas gate `eligible` that decides where K2 takes the site instead.

JAX is run eagerly where rounding is compared bit for bit: under `jax.jit`
XLA keeps f32 between some bf16 operations (`xla_allow_excess_precision`),
so its jitted gradient is not the per-operation rounding that the
composition defines; with that flag off the jitted gradient equals the
eager one (on the CPU, JAX 0.9.0 and flax 0.12.3)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn
from flax.traverse_util import flatten_dict

from anoddpm_tpu.models.unet import GroupNorm32 as FlaxGroupNorm32
from anoddpm_tpu.models.unet import UNet as FlaxUNet
from anoddpm_tpu.ops import pallas_norm
from anoddpm_torch.compat.flax_params import unet_state_dict_from_flax
from anoddpm_torch.models import unet as port_unet
from anoddpm_torch.ops.group_norm_silu import VMEM_SAMPLE_BYTES, eligible
from torch_parity import nchw, nhwc

DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
SITE_SHAPES = [(2, 8, 8, 64), (2, 4, 4, 192), (1, 16, 16, 32)]  # NHWC


class FlaxSite(fnn.Module):
    """`_norm_silu` of the JAX UNet with pallas_norm off."""
    bf16_path: bool

    @fnn.compact
    def __call__(self, x):
        return fnn.silu(FlaxGroupNorm32(bf16_path=self.bf16_path)(x))


def site_inputs(shape, seed=0):
    """x (bf16-exact values k/16, |k| <= 64, so that every fp32 sum of the
    statistics is exact in any order), the output gradient, gamma, beta."""
    rng = np.random.default_rng(seed)
    x = (rng.integers(-64, 65, shape) / 16).astype(np.float32)
    g = rng.standard_normal(shape).astype(np.float32)
    c = shape[-1]
    gamma = (1 + 0.1 * rng.standard_normal(c)).astype(np.float32)
    beta = (0.1 * rng.standard_normal(c)).astype(np.float32)
    return x, g, gamma, beta


def jax_site(x, g, gamma, beta, bf16_path, jdtype):
    """(out, dx, dgamma, dbeta) of the JAX site, eager `jax.vjp`, as numpy
    fp32 in NHWC."""
    params = {"params": {"GroupNorm32_0": {"GroupNorm_0": {
        "scale": jnp.asarray(gamma), "bias": jnp.asarray(beta)}}}}
    out, vjp = jax.vjp(lambda p, xx: FlaxSite(bf16_path).apply(p, xx), params,
                       jnp.asarray(x).astype(jdtype))
    dp, dx = vjp(jnp.asarray(g).astype(jdtype))
    leaf = dp["params"]["GroupNorm32_0"]["GroupNorm_0"]
    f32 = lambda a: np.asarray(jnp.asarray(a).astype(jnp.float32))
    return f32(out), f32(dx), f32(leaf["scale"]), f32(leaf["bias"])


def port_site(x, g, gamma, beta, bf16_path, tdtype):
    """The same from `unet.flax_norm` under autograd."""
    tx = nchw(x).to(tdtype).requires_grad_()
    tg = torch.from_numpy(gamma).requires_grad_()
    tb = torch.from_numpy(beta).requires_grad_()
    out = port_unet.flax_norm(tx, tg, tb, bf16_path, True)
    out.backward(nchw(g).to(tdtype))
    return (nhwc(out.detach().float()), nhwc(tx.grad.float()),
            tg.grad.numpy(), tb.grad.numpy())


@pytest.mark.parametrize("bf16_path", [False, True])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", SITE_SHAPES)
def test_site_matches_jax_composition(shape, dtype, bf16_path):
    """bf16: the output equals `nn.silu(GroupNorm32(bf16_path)(x))` bit for
    bit, and dx equals JAX's in at least 99.5% of elements, the rest within
    one bf16 ulp of dx's largest magnitude (bf16_path=False sums three fp32
    cotangents before its one rounding, in another order than JAX, and
    where they nearly cancel the rounding of a small sum moves).  fp32:
    XLA's exp and rsqrt on the CPU are not torch's (they differ in the last
    bit on 10% and 35% of inputs), so the output is held to 4 fp32 ulps of
    its largest magnitude; against a float64 evaluation from the same
    inputs the output of JAX eager is off by 2.56, 2.07, 2.65 ulps of the
    largest at the three shapes, JAX jit by 2.83, 2.07, 2.65, the port by
    2.43, 2.07, 2.37 (by 3.18, 2.07, 3.49 while its rsqrt was torch's;
    `scripts/parity_oracles.py site`).  dx within 1e-5 of its largest magnitude
    (2e-7 here).  dgamma and dbeta sum over N H W in another order: 1e-5 of
    their largest magnitude."""
    tdtype, jdtype = DTYPES[dtype]
    x, g, gamma, beta = site_inputs(shape)
    want = jax_site(x, g, gamma, beta, bf16_path, jdtype)
    got = port_site(x, g, gamma, beta, bf16_path, tdtype)
    if dtype == "bfloat16":
        np.testing.assert_array_equal(got[0], want[0])
        assert (got[1] == want[1]).mean() >= 0.995
        np.testing.assert_allclose(got[1], want[1], rtol=0,
                                   atol=np.abs(want[1]).max() / 2 ** 7)
    else:
        np.testing.assert_allclose(got[0], want[0], rtol=0, atol=4 * np.spacing(
            np.abs(want[0]).max()))
        np.testing.assert_allclose(got[1], want[1], rtol=0,
                                   atol=1e-5 * np.abs(want[1]).max())
    for k in (2, 3):
        np.testing.assert_allclose(got[k], want[k], rtol=0,
                                   atol=1e-5 * np.abs(want[k]).max())


@pytest.mark.parametrize("shape", SITE_SHAPES)
def test_bf16_path_changes_only_the_backward(shape):
    """In bf16 the two paths give the same output and dx that differ; the
    port's dx of each path equals JAX's of the same path in more elements
    than JAX's of the other path."""
    x, g, gamma, beta = site_inputs(shape, seed=3)
    jax_out = {p: jax_site(x, g, gamma, beta, p, jnp.bfloat16) for p in (False, True)}
    port_out = {p: port_site(x, g, gamma, beta, p, torch.bfloat16) for p in (False, True)}
    np.testing.assert_array_equal(jax_out[True][0], jax_out[False][0])
    assert (jax_out[True][1] != jax_out[False][1]).mean() > 0.01
    for p in (False, True):
        np.testing.assert_array_equal(port_out[p][0], jax_out[p][0])
        own = (port_out[p][1] == jax_out[p][1]).mean()
        other = (port_out[p][1] == jax_out[not p][1]).mean()
        assert own > other + 0.01, (p, own, other)


def test_group_norm_without_silu_matches_flax():
    """The attention norm under "flax": flax's GroupNorm32 alone, in bf16
    with each bf16_path, bit for bit forward."""
    x, g, gamma, beta = site_inputs((2, 8, 8, 128), seed=7)
    for bf16_path in (False, True):
        params = {"params": {"GroupNorm_0": {"scale": jnp.asarray(gamma),
                                             "bias": jnp.asarray(beta)}}}
        want = FlaxGroupNorm32(bf16_path=bf16_path).apply(
            params, jnp.asarray(x).astype(jnp.bfloat16))
        got = port_unet.flax_norm(nchw(x).bfloat16(), torch.from_numpy(gamma),
                                  torch.from_numpy(beta), bf16_path, False)
        np.testing.assert_array_equal(
            nhwc(got.float()), np.asarray(want.astype(jnp.float32)))


def test_eligible_matches_pallas_gate():
    assert VMEM_SAMPLE_BYTES == pallas_norm.VMEM_SAMPLE_BYTES
    for b in (1, 4):
        for hw in (1, 4, 8, 16, 32, 64, 128, 256):
            for c in (32, 64, 96, 128, 192, 256, 384, 512, 640):
                for tdtype, jdtype in DTYPES.values():
                    shape = (b, hw, hw, c)
                    assert eligible(shape, tdtype) == pallas_norm.eligible(
                        shape, jdtype), (shape, tdtype)
    assert not eligible((4, 128, 128), torch.float32)
    assert not pallas_norm.eligible((4, 128, 128), jnp.float32)


# UNet level: 32^2, base 64, mults (1, 2), attention at 16; s2d 1 and 2.
def unet_pair(s2d, bf16_norm, pallas_norm, dtype, seed=0):
    tdtype, jdtype = DTYPES[dtype]
    cfg = dict(img_size=32, base_channels=64, channel_mults=(1, 2),
               attention_resolutions="16", space_to_depth=s2d)
    fmodel = FlaxUNet(**cfg, bf16_norm=bf16_norm, pallas_norm=pallas_norm,
                      dtype=jdtype)
    params = jax.jit(fmodel.init)(jax.random.key(seed), jnp.zeros((1, 32, 32, 1)),
                                  jnp.zeros((1,), jnp.int32))
    rng = np.random.default_rng(seed + 5)
    params = jax.tree_util.tree_map(
        lambda p: np.asarray(p) + rng.normal(0, 0.05, p.shape).astype(np.float32),
        params)
    port = port_unet.UNet(**cfg, dtype=tdtype, norm_impl="flax",
                          bf16_norm=bf16_norm, pallas_norm=pallas_norm)
    port.load_state_dict(unet_state_dict_from_flax(params), strict=True)
    return fmodel, params, port


def unet_inputs():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 32, 32, 1)).astype(np.float32)
    gout = rng.normal(size=(2, 32, 32, 1)).astype(np.float32)
    return x, np.array([3, 17], np.int32), gout


def pscale_count(params):
    """The sites at which flax took its Pallas kernel."""
    return sum(path[-1].endswith("_pscale") for path in flatten_dict(params))


@pytest.mark.parametrize("pallas_norm", [False, True])
@pytest.mark.parametrize("s2d", [1, 2])
def test_unet_fp32_matches_flax(s2d, pallas_norm):
    """fp32: the flax tree (with `{name}_pscale/_pbias` at the eligible
    sites under pallas_norm) converts and runs under `norm_impl="flax"`
    within `tests/test_torch_unet.py`'s atol 2e-4 / rtol 1e-3 (bf16_norm
    changes nothing in fp32)."""
    fmodel, params, port = unet_pair(s2d, False, pallas_norm, "float32")
    assert (pscale_count(params) > 0) == pallas_norm
    x, t, _ = unet_inputs()
    want = np.asarray(jax.jit(fmodel.apply)(params, jnp.asarray(x), jnp.asarray(t)))
    with torch.no_grad():
        got = nhwc(port(nchw(x), torch.from_numpy(t.astype(np.int64))))
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-3)


@pytest.mark.parametrize("pallas_norm", [False, True])
@pytest.mark.parametrize("bf16_norm", [False, True])
@pytest.mark.parametrize("s2d", [1, 2])
def test_unet_bf16_matches_flax(s2d, bf16_norm, pallas_norm, monkeypatch):
    """bf16 against JAX's eager forward and `jax.vjp`.  The two nets round
    differently from their first layers on (the timestep embedding's
    sin/cos, bias adds that flax rounds apart from the conv, pooling), in a
    quarter to most of the elements by one bf16 ulp, and bf16 carries that
    through: the output is held to 5% of its largest magnitude, each
    parameter's gradient to 6% of its largest magnitude in the median over
    the parameters and 30% at most (measured on the CPU: 2.6-3.0%,
    3.1-3.8% and 19%; JAX's own jitted run differs from its eager one by
    2.2-3.6%, 2.6-3.2% and 15%).  K2 runs exactly at the sites where flax
    names `{name}_pscale` (counted by a mock of the K2 wrapper)."""
    fmodel, params, port = unet_pair(s2d, bf16_norm, pallas_norm, "bfloat16")
    calls = []
    real = port_unet.group_norm_silu
    monkeypatch.setattr(port_unet, "group_norm_silu",
                        lambda *a: calls.append(a[0].shape) or real(*a))
    x, t, gout = unet_inputs()
    out, vjp = jax.vjp(lambda p, xx: fmodel.apply(p, xx, jnp.asarray(t)),
                       params, jnp.asarray(x))
    want_grads = unet_state_dict_from_flax(vjp(jnp.asarray(gout))[0])
    got = port(nchw(x), torch.from_numpy(t.astype(np.int64)))
    got.backward(nchw(gout))
    assert len(calls) == pscale_count(params)
    out = np.asarray(out)
    assert np.abs(nhwc(got.detach()) - out).max() <= 0.05 * np.abs(out).max()
    rel = [float((p.grad - want_grads[n]).abs().max() / want_grads[n].abs().max())
           for n, p in port.named_parameters() if want_grads[n].abs().max() > 0]
    assert np.median(rel) <= 0.06 and max(rel) <= 0.3, (np.median(rel), max(rel))


@pytest.mark.parametrize("s2d", [1, 2])
def test_unet_sites_follow_their_bf16_path(s2d):
    """At every flax-order site of the bf16 UNet, on the input and output
    gradient that the port's own backward gives it: the port's site with
    bf16_norm=True has JAX's bf16_path=True dx and not its False one (and
    the other way round).  Over the whole UNet the two packages' bf16
    gradients differ by more than the two paths do (the test above), so the
    paths are told apart where they act."""
    _, _, port = unet_pair(s2d, True, False, "bfloat16")
    sites = []

    def record(mod, inp, out):
        entry = [mod, inp[0].detach(), None]
        sites.append(entry)
        out.register_hook(lambda g: entry.__setitem__(2, g))

    for m in port.modules():
        if isinstance(m, port_unet.NormSiLU):
            m.register_forward_hook(record)
    x, t, gout = unet_inputs()
    out = port(nchw(x), torch.from_numpy(t.astype(np.int64)))
    out.backward(nchw(gout))
    sites = [e for e in sites if e[1].dtype == torch.bfloat16]
    assert len(sites) >= 20
    told_apart = 0
    for mod, xin, g in sites:
        xs, gs = nhwc(xin.float()), nhwc(g.float())
        gamma = mod.weight.detach().numpy()
        beta = mod.bias.detach().numpy()
        dx = {p: jax_site(xs, gs, gamma, beta, p, jnp.bfloat16)[1]
              for p in (False, True)}
        for p in (False, True):
            got = port_site(xs, gs, gamma, beta, p, torch.bfloat16)[1]
            own, other = (got == dx[p]).mean(), (got == dx[not p]).mean()
            assert own >= 0.995, (tuple(xin.shape), p, own)
            if (dx[True] != dx[False]).any():
                assert own > other, (tuple(xin.shape), p, own, other)
                told_apart += 1
    assert told_apart >= len(sites)


def test_unet_from_args_reads_the_norm_keys():
    """`norm_impl` (the port's key) decides whether `bf16_norm` and
    `pallas_norm` act; args256syn64s2d sets bf16_norm and stays on K2."""
    from anoddpm_torch.config import load_args
    args = load_args("256syn64s2d")
    with torch.device("meta"):
        kernel = port_unet.unet_from_args(args, 1)
        flax = port_unet.unet_from_args({**args, "norm_impl": "flax",
                                         "pallas_norm": True}, 1)
    norms = lambda m: [x for x in m.modules()
                       if isinstance(x, port_unet.GroupNorm32)]
    assert {(n.norm_impl, n.bf16_norm) for n in norms(kernel)} == {("kernel", True)}
    assert {(n.norm_impl, n.bf16_norm) for n in norms(flax)} == {("flax", True)}
    assert all(n.pallas_norm for n in norms(flax)
               if isinstance(n, port_unet.NormSiLU))
    x = torch.zeros((1, 64, 8, 8))
    assert kernel.out_norm.uses_kernel(x) and not flax.out_norm.uses_kernel(x)
    with pytest.raises(ValueError, match="norm_impl"):
        port_unet.UNet(img_size=32, base_channels=32, norm_impl="xla")
