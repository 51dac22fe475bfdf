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
