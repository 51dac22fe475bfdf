"""The port's training snapshots, training videos and test-set videos
against the JAX package's: the same files under the same names.

Both trainers resume from one JAX checkpoint at epoch 449 of the 32^2
config and run to epoch 500 at one step an epoch (epoch 450 writes the
x_t / eps snapshot, 500 the one-step EMA sample grid and the "half"-
sequence video; the every-500-epochs video needs an epoch past the
resumed one).  The test-set suite runs with a one-layer stand-in for the
UNet on both sides at T = 101, where lambda = 100 gives one video.  A
video is an .mp4 where imageio has a writer for it, else a .gif, on both
sides alike."""
import os

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anoddpm_tpu import checkpoint as jckpt
from anoddpm_tpu import evaluation as jev
from anoddpm_tpu import train as jtrain
from anoddpm_tpu import training as jtr
from anoddpm_tpu.config import defaultdict_from_json
from anoddpm_tpu.data.pipeline import batch_iterator as jbatches
from anoddpm_tpu.data.synthetic import SyntheticMRIDataset as JaxHealthy
from anoddpm_tpu.models.unet import unet_from_args
from anoddpm_tpu.schedule import get_beta_schedule, make_schedule
from anoddpm_tpu.training import EvalModel
from anoddpm_torch import evaluation as tev
from anoddpm_torch import schedule as ts
from anoddpm_torch import train as ttrain
from anoddpm_torch.data.datasets import dataset_from_args
from anoddpm_torch.data.pipeline import batch_iterator as tbatches
from torch_parity import CONFIGS, flax_and_port

ARGS = {"img_size": [32, 32], "Batch_Size": 2, "EPOCHS": 500, "T": 10,
        "base_channels": 32, "channel_mults": "1 2",
        "attention_resolutions": "16", "beta_schedule": "cosine",
        "loss-type": "l2", "lr": 1e-4, "sample_distance": 8,
        "train_start": True, "noise_fn": "simplex", "dataset": "synthetic",
        "iters_per_epoch": 1, "checkpoint_every": 1000, "save_imgs": True,
        "save_vids": True, "skip_test_eval": True, "seed": 0,
        "compute_dtype": "float32"}


def files(root):
    """Relative paths of the files under root, videos as name.video."""
    out = set()
    for d, _, names in os.walk(root):
        for f in names:
            rel = os.path.relpath(os.path.join(d, f), root)
            out.add(rel[:-4] + ".video" if rel.endswith((".gif", ".mp4")) else rel)
    return out


def test_train_snapshots_and_videos_match_jax(tmp_path):
    """A one-level UNet (channel_mults 1) keeps JAX's compiles short."""
    args = {**ARGS, "arg_num": "snap", "channel_mults": "1",
            "attention_resolutions": "8"}
    params = unet_from_args(defaultdict_from_json(args), 1).init(
        jax.random.key(4), jnp.zeros((1, 32, 32, 1)), jnp.zeros((1,), jnp.int32))
    opt = jtr.make_optimizer(ARGS["lr"], 0.0, 1.0).init(params)
    for name in ("jax", "port"):
        jckpt.save_checkpoint(str(tmp_path / name), defaultdict_from_json(args),
                              449, params, params, opt, final=True)
    jtrain.train(defaultdict_from_json(args), root_dir=str(tmp_path / "jax"),
                 resume="RESUME_FINAL")
    state = ttrain.train(defaultdict_from_json(args),
                         root_dir=str(tmp_path / "port"), resume="RESUME_FINAL",
                         device="cpu")
    assert state.step == 52
    artifacts = {p for p in files(tmp_path / "port")
                 if p.startswith("diffusion-")}
    assert artifacts == {p for p in files(tmp_path / "jax")
                         if p.startswith("diffusion-")} == {
        "diffusion-training-images/ARGS=snap/EPOCH=450.png",
        "diffusion-training-images/ARGS=snap/EPOCH=500.png",
        "diffusion-videos/ARGS=snap/sample-EPOCH=500.video"}


class TinyFlax(fnn.Module):
    @fnn.compact
    def __call__(self, x, t):
        return 0.1 * fnn.Conv(x.shape[-1], (1, 1))(x)


class TinyTorch(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.conv = torch.nn.Conv2d(1, 1, 1)

    def forward(self, x, t):
        return 0.1 * self.conv(x)


def test_testing_videos_match_jax(tmp_path):
    module = TinyFlax()
    params = module.init(jax.random.key(0), jnp.zeros((1, 8, 8, 1)),
                         jnp.zeros((1,), jnp.int32))
    args = defaultdict_from_json({"arg_num": "tv", "sample_distance": 101})
    data = defaultdict_from_json({"img_size": (32, 32)})
    want = jev.testing(jbatches(JaxHealthy((32, 32), seed=1), 1), EvalModel(
        module, params), make_schedule(get_beta_schedule(101, "cosine")), args,
        root_dir=str(tmp_path / "jax"), n_images=1, save_videos=True)
    got = tev.testing(tbatches(dataset_from_args(".", data, train=False), 1),
                      TinyTorch(), ts.make_schedule(ts.get_beta_schedule(101, "cosine")),
                      args, root_dir=str(tmp_path / "port"), n_images=1,
                      save_videos=True)
    assert got.keys() == want.keys()
    assert files(tmp_path / "port") == files(tmp_path / "jax") == {
        "diffusion-videos/ARGS=tv/test-set/t=100.video", "metrics/argstv-test.json"}


def test_evaluation_cli(tmp_path, monkeypatch, capsys):
    """`python -m anoddpm_torch.evaluation <N>` on a JAX checkpoint of the
    32^2 config, on the CPU; without a card and without device="cpu" it
    raises."""
    _, params, _ = flax_and_port(CONFIGS["s2d1"], seed=5)
    args = defaultdict_from_json({**ARGS, "arg_num": "ev", "T": 10,
                                  "Batch_Size": 8, "save_vids": False})
    jckpt.save_checkpoint(str(tmp_path), args, 3, params, params, {}, final=True)
    monkeypatch.chdir(tmp_path)
    results = tev.main(["ev"], device="cpu")
    assert all(np.isfinite(v) for v in results.values())
    assert (tmp_path / "metrics" / "argsev-test.json").exists()
    assert "Test set PSNR" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        tev.main([], device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tev.main(["ev"])
