"""The port's UNet against the flax UNet: converted (perturbed) weights give
the same fp32 outputs, and the parameter counts agree."""
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anoddpm_torch.models.unet import UNet, unet_from_args
from torch_parity import CONFIGS, flax_and_port, port_apply


@pytest.mark.parametrize("name", list(CONFIGS))
def test_outputs_match_flax(name):
    cfg = CONFIGS[name]
    fmodel, params, port = flax_and_port(cfg)
    if cfg.get("pallas_norm"):
        assert "norm_in_pscale" in params["params"]["down_0_0"]
    n_flax = sum(int(np.prod(p.shape)) for p in jax.tree_util.tree_leaves(params))
    assert n_flax == sum(p.numel() for p in port.parameters())
    img = cfg["img_size"]
    x = np.random.default_rng(1).normal(size=(2, img, img, 1)).astype(np.float32)
    apply = jax.jit(fmodel.apply)
    for t_val in (0, 5, 27):
        t = np.full((2,), t_val, np.int32)
        want = np.asarray(apply(params, jnp.asarray(x), jnp.asarray(t)))
        np.testing.assert_allclose(port_apply(port, x, t), want, atol=2e-4,
                                   rtol=1e-3)


GOLDENS = json.loads(
    (pathlib.Path(__file__).parent / "golden" / "unet_goldens.json").read_text())


@pytest.mark.parametrize("key", list(GOLDENS))
def test_param_count_matches_golden(key):
    """Parameter counts of the reference model (the goldens the flax UNet
    is held to), built on the meta device: no memory, no compute."""
    img, base, in_ch, heads, head_ch, attn = key.rsplit("_", 5)
    with torch.device("meta"):
        port = UNet(img_size=int(img), base_channels=int(base),
                    in_channels=int(in_ch), n_heads=int(heads),
                    n_head_channels=int(head_ch), attention_resolutions=attn)
    assert sum(p.numel() for p in port.parameters()) == GOLDENS[key]["params"]


def test_paper_config_structure():
    """args256syn128 (the main path's model): 42 ResBlocks with two
    norm+SiLU sites each plus out_norm = 85 K2 sites per forward; bf16
    compute with the output conv in fp32; the golden parameter count."""
    from anoddpm_torch.config import load_args
    from anoddpm_torch.models.unet import NormSiLU, ResBlock
    with torch.device("meta"):
        port = unet_from_args(load_args("256syn128"), 1)
    assert sum(isinstance(m, ResBlock) for m in port.modules()) == 42
    assert sum(type(m) is NormSiLU for m in port.modules()) == 85
    assert port.stem.dtype == torch.bfloat16
    assert port.out_conv.dtype == torch.float32
    assert (sum(p.numel() for p in port.parameters())
            == GOLDENS["256_128_1_2_-1_16,8"]["params"])


@pytest.mark.parametrize("kind", ["conv", "dense"])
def test_init_is_flax_lecun_normal(kind):
    """Conv and dense kernels start from flax's default init, lecun_normal:
    a normal truncated at +-2 s, s = sqrt(1/fan_in) / 0.8796, against JAX's
    own draw of the same shape (fan_in 1,152, 147,456 weights): the std
    within 2%, no weight beyond 2 s, and a two-sample KS statistic below
    0.01.  Zero-initialised layers stay zero."""
    from scipy.stats import ks_2samp
    from flax.linen.linear import default_kernel_init
    from anoddpm_torch.models.unet import Conv, Dense
    torch.manual_seed(0)
    if kind == "conv":
        layer, shape = Conv(128, 128, 3, torch.float32), (3, 3, 128, 128)
        zero = Conv(128, 128, 3, torch.float32, zero=True)
    else:
        layer, shape = Dense(1152, 128, torch.float32), (1152, 128)
        zero = Dense(1152, 128, torch.float32, zero=True)
    fan_in = int(np.prod(shape[:-1]))
    got = layer.weight.detach().numpy().ravel()
    want = np.asarray(default_kernel_init(jax.random.key(0), shape,
                                          jnp.float32)).ravel()
    s = np.sqrt(1.0 / fan_in) / 0.87962566103423978
    assert got.size == want.size >= 10 ** 5 and fan_in >= 1152
    assert abs(got.std() / want.std() - 1.0) <= 0.02
    assert np.abs(got).max() <= 2 * s + 1e-6
    assert ks_2samp(got, want).statistic < 0.01
    assert not zero.weight.detach().any() and not layer.bias.detach().any()


# lecun_normal's truncation: s = sqrt(1/fan_in) / this, cut at +-2 s
_TRUNC_STD = 0.87962566103423978


def _fresh_pair(config: str):
    """A fresh port UNet under torch seed 0 (as `train.new_train_state`
    builds it) and the JAX UNet's `init` under key 0 (as
    `training.init_train_state` calls it), both from configs/args{config},
    the JAX side mapped onto the port's names: two dicts of numpy arrays."""
    from anoddpm_tpu.models.unet import unet_from_args as jax_unet_from_args
    from anoddpm_torch.compat.flax_params import unet_state_dict_from_flax
    from anoddpm_torch.config import load_args
    args = load_args(config)
    img = args["img_size"][0]
    torch.manual_seed(0)
    port = unet_from_args(args, 1)
    fmodel = jax_unet_from_args(args, 1)
    params = jax.jit(fmodel.init)(jax.random.key(0),
                                  jnp.zeros((1, img, img, 1), jnp.float32),
                                  jnp.zeros((1,), jnp.int32))
    got = {k: v.detach().float().numpy() for k, v in port.state_dict().items()}
    want = {k: v.numpy() for k, v in unet_state_dict_from_flax(params).items()}
    return got, want


@pytest.mark.parametrize("config", ["256syn64s2d", "256syn128"])
def test_whole_unet_init_matches_flax(config):
    """Every parameter of a fresh UNet against flax's `init` of the same
    config (bf16 compute): the same names and shapes, the same all-zero
    parameters (biases, conv_out, attention's proj, out_conv) and all-one
    norm scales, and every other kernel lecun_normal on its own fan_in
    (in x kh x kw; the stem's fan_in is 9 x s2d^2 after space-to-depth):
    no weight beyond 2 s on either side, s = sqrt(1/fan_in) / 0.8796; each
    kernel divided by its s and all pooled, a two-sample KS statistic below
    0.01 against JAX's pooled draw (4M weights of each pool drawn from a
    seed: args256syn128 pools 130M); a kernel of 4,096 weights or more with
    its std within 3% of flax's."""
    from scipy.stats import ks_2samp
    got, want = _fresh_pair(config)
    assert sorted(got) == sorted(want)
    assert {k: v.shape for k, v in got.items()} == {k: v.shape for k, v in want.items()}
    zeros = lambda d: {k for k, v in d.items() if not v.any()}
    ones = lambda d: {k for k, v in d.items() if (v == 1).all()}
    assert zeros(got) == zeros(want)
    assert ones(got) == ones(want)
    assert all(k.endswith(".weight") and got[k].ndim == 1 for k in ones(got))
    kernels = sorted(k for k in got if got[k].ndim >= 2 and k not in zeros(got))
    assert "stem.weight" in kernels and got["stem.weight"].shape[1] == (
        4 if "s2d" in config else 1)
    pooled_got, pooled_want, wide = [], [], 0
    for k in kernels:
        fan_in = int(np.prod(got[k].shape[1:]))
        s = np.sqrt(1.0 / fan_in) / _TRUNC_STD
        for side in (got[k], want[k]):
            assert np.abs(side).max() <= 2 * s * (1 + 1e-6), k
        pooled_got.append(got[k].ravel() / s)
        pooled_want.append(want[k].ravel() / s)
        if got[k].size >= 4096:
            wide += 1
            assert abs(got[k].std() / want[k].std() - 1.0) <= 0.03, k
    assert wide >= len(kernels) - 2
    pooled_got, pooled_want = np.concatenate(pooled_got), np.concatenate(pooled_want)
    pick = np.random.default_rng(0).integers(0, pooled_got.size, 1 << 22)
    assert ks_2samp(pooled_got[pick], pooled_want[pick]).statistic < 0.01
