"""The UNet options that no shipped config reaches, against the JAX UNet:
`biggan_updown=False` (a strided 3 x 3 conv down with flax's asymmetric
(0, 1) "SAME" padding, nearest x 2 then a 3 x 3 conv up) and
`use_conv_skip` (3 x 3 skip convs), each with the flax parameters carried
over by `compat.flax_params`, within the default UNet's tolerance
(tests/test_torch_unet.py: atol 2e-4)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import anoddpm_torch.models.unet as tunet
import anoddpm_tpu.models.unet as junet
from anoddpm_torch.compat.flax_params import unet_state_dict_from_flax
from anoddpm_torch.models.unet import Conv, UNet, same_padding
from torch_parity import port_apply

BASE = dict(img_size=32, base_channels=32, channel_mults=(1, 2),
            attention_resolutions="16")


class ConvSkipResBlock(junet.ResBlock):
    use_conv_skip: bool = True


class PortConvSkipResBlock(tunet.ResBlock):
    def __init__(self, *args, **kw):
        super().__init__(*args, use_conv_skip=True, **kw)


def flax_params(fmodel, seed=0):
    params = fmodel.init(jax.random.key(seed), jnp.zeros((1, 32, 32, 1)),
                         jnp.zeros((1,), jnp.int32))
    rng = np.random.default_rng(seed + 5)
    return jax.tree_util.tree_map(
        lambda p: np.asarray(p) + rng.normal(0, 0.05, p.shape).astype(np.float32),
        params)


@pytest.mark.parametrize("option", ["biggan_updown_false", "use_conv_skip"])
def test_option_matches_flax(option, monkeypatch):
    if option == "use_conv_skip":
        # both UNets build ResBlock(use_conv_skip=False); their blocks take
        # the option through each module's ResBlock
        monkeypatch.setattr(junet, "ResBlock", ConvSkipResBlock)
        monkeypatch.setattr(tunet, "ResBlock", PortConvSkipResBlock)
        fmodel, port_kw = junet.UNet(**BASE), {}
    else:
        fmodel = junet.UNet(**BASE, biggan_updown=False)
        port_kw = dict(biggan_updown=False)
    params = flax_params(fmodel)
    sd = unet_state_dict_from_flax(params)
    if option == "use_conv_skip":
        assert sd["up_1_0.skip.weight"].shape[-2:] == (3, 3)
    else:
        assert sd["down_sample_0.weight"].shape[-2:] == (3, 3)
        assert sd["up_sample_1.weight"].shape[-2:] == (3, 3)
    port = UNet(**BASE, **port_kw)
    port.load_state_dict(sd, strict=True)
    port.eval()
    x = np.random.default_rng(1).normal(size=(2, 32, 32, 1)).astype(np.float32)
    t = np.array([3, 17])
    want = np.asarray(fmodel.apply(params, jnp.asarray(x), jnp.asarray(t)))
    np.testing.assert_allclose(port_apply(port, x, t), want, atol=2e-4, rtol=0)


def test_strided_conv_pads_like_flax():
    """A 3 x 3 stride-2 conv on 8 x 8 pads (0, 1): its output equals
    flax's, and differs from a symmetric padding of 1."""
    assert same_padding(8, 3, 2) == (0, 1) and same_padding(7, 3, 2) == (1, 1)
    conv = Conv(1, 1, 3, torch.float32, stride=2)
    x = np.random.default_rng(2).normal(size=(1, 8, 8, 1)).astype(np.float32)
    fconv = junet.nn.Conv(1, (3, 3), strides=(2, 2), padding="SAME")
    fparams = {"params": {"kernel": conv.weight.detach().numpy().transpose(2, 3, 1, 0),
                          "bias": conv.bias.detach().numpy()}}
    want = np.asarray(fconv.apply(fparams, jnp.asarray(x)))
    with torch.no_grad():
        got = conv(torch.from_numpy(x.transpose(0, 3, 1, 2))).numpy()
        sym = torch.nn.functional.conv2d(torch.from_numpy(x.transpose(0, 3, 1, 2)),
                                         conv.weight, conv.bias, stride=2,
                                         padding=1).numpy()
    np.testing.assert_allclose(got.transpose(0, 2, 3, 1), want, atol=1e-6)
    assert np.abs(sym.transpose(0, 2, 3, 1) - want).max() > 1e-3
