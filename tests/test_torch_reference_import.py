"""The reference checkpoint import of the port (`compat.torch_import`)
against the JAX package's `import_reference_unet_state` followed by
`compat.flax_params.unet_state_dict_from_flax`, bit for bit.

The reference's state_dict is built under the key names the JAX importer
reads: a first pass through it with a recording mapping finds the names
(each placeholder carries its own id, so the conversion tells which port
parameter each becomes, and so its shape); then every tensor is drawn
from a seeded numpy generator."""
import numpy as np
import pytest
import torch

from anoddpm_tpu.compat.torch_import import import_reference_unet_state as jax_import
from anoddpm_torch.compat.flax_params import unet_state_dict_from_flax
from anoddpm_torch.compat.torch_import import (import_reference_unet_state,
                                               load_reference_checkpoint)
from anoddpm_torch.models.unet import UNet

CASES = {
    "32_16": dict(img_size=32, base_channels=32, channel_mults=(1, 2),
                  attention_resolutions="16"),
    "32_two_heads": dict(img_size=32, base_channels=32, channel_mults=(1, 2, 2),
                         attention_resolutions="16,8", n_heads=2),
}


class Recording(dict):
    """Returns, for every key asked for, a one-element array holding the
    key's id; remembers the keys."""

    def __getitem__(self, key):
        if key not in self:
            dict.__setitem__(self, key, len(self) + 1)
        ident = dict.__getitem__(self, key)
        return np.full((1, 1, 1, 1) if key.endswith("weight") else (1,),
                       ident, np.float32)


def reference_state_dict(cfg, seed=0):
    """A reference-named state_dict of seeded arrays in the reference's
    layouts (Conv1d QKV and projections (O, I, 1))."""
    kw = dict(channel_mults=cfg["channel_mults"],
              attention_resolutions=cfg["attention_resolutions"])
    rec = Recording()
    port_of = {}
    for name, value in unet_state_dict_from_flax(
            jax_import(rec, cfg["img_size"], cfg["base_channels"], **kw)).items():
        port_of[int(value.flatten()[0])] = name
    shapes = {n: p.shape for n, p in UNet(**cfg).state_dict().items()}
    rng = np.random.default_rng(seed)
    sd = {}
    for key, ident in dict.items(rec):
        shape = tuple(shapes[port_of[ident]])
        if key.endswith("weight") and (".to_qkv." in key or ".proj_out." in key):
            shape += (1,)
        sd[key] = rng.normal(size=shape).astype(np.float32)
    return sd, kw


@pytest.mark.parametrize("name", sorted(CASES))
def test_import_equals_jax_import_then_conversion(name):
    cfg = CASES[name]
    sd, kw = reference_state_dict(cfg)
    want = unet_state_dict_from_flax(
        jax_import(sd, cfg["img_size"], cfg["base_channels"], **kw))
    got = import_reference_unet_state(
        {k: torch.from_numpy(v) for k, v in sd.items()}, cfg["img_size"],
        cfg["base_channels"], **kw)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == torch.float32
        assert torch.equal(got[k], want[k]), k
    UNet(**{k: v for k, v in cfg.items()}).load_state_dict(got, strict=True)


def test_load_reference_checkpoint(tmp_path):
    cfg = CASES["32_16"]
    sd, kw = reference_state_dict(cfg, seed=1)
    ema = {k: torch.from_numpy(v) for k, v in sd.items()}
    model = {k: v + 1 for k, v in ema.items()}
    path = tmp_path / "params-final.pt"
    torch.save({"ema": ema, "model_state_dict": model, "n_epoch": 3}, path)
    got = load_reference_checkpoint(str(path), 32, 32, **kw)
    raw = load_reference_checkpoint(str(path), 32, 32, use_ema=False, **kw)
    want = import_reference_unet_state(ema, 32, 32, **kw)
    for k in want:
        assert torch.equal(got[k], want[k]) and torch.equal(raw[k], want[k] + 1)
