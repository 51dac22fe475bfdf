"""The port's detection sweeps against the JAX package on the CPU.

- `graph_data` and `roc_data` on a 32^2 synthetic config: both packages
  read one checkpoint written by `anoddpm_tpu.checkpoint`, and both
  modules' `sampler_from_args` is patched to one per-sample noise bank.
  Every number of the per-volume CSV, the pooled CSV and
  `roc-comparison.csv` agrees within 1e-4 (the per-volume CSV rounds to 4
  digits, so there within 1e-4 plus half a unit of its last digit); a
  value of the ROC CSV may instead differ by at most one pixel's step of
  the curve (1/P of the tpr, 1/N of the fpr), where two pixels whose
  scores differ by less than the recon's tolerance swap places.
- Methods A and B, `detection_A_fixedT` and `anomalous_validation`: the
  same artifact names and counts as the JAX package's, with a one-layer
  stand-in for the UNet on both sides at T = 100 (below T = 100 the
  sweeps' lambda grids {50, 100, ...} are empty and write nothing).
- `sharded_anomalous_metrics` on a mesh of one device against the port's
  without one, its last chunk wrap-padded: reconstructions within 1e-5,
  the same CSV text.
- The CLI modes on a 32^2 checkpoint at T = 20 with device="cpu", and the
  parts that once raised (the context-encoder curve, randParam
  validation)."""
import csv
import os

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from anoddpm_tpu import checkpoint as jckpt
from anoddpm_tpu import detect as jdetect
from anoddpm_tpu.config import defaultdict_from_json
from anoddpm_tpu.schedule import get_beta_schedule, make_schedule
from anoddpm_tpu.training import EvalModel
from anoddpm_torch import detect as tdetect
from anoddpm_torch import schedule as ts
from torch_parity import CONFIGS, T, flax_and_port, per_sample_bank_samplers

ARGS = {"img_size": [32, 32], "T": T, "beta_schedule": "cosine",
        "base_channels": 32, "channel_mults": "1 2",
        "attention_resolutions": "16", "noise_fn": "simplex",
        "dataset": "synthetic", "compute_dtype": "float32",
        "anomalous_volumes": 1, "Batch_Size": 2, "sample_distance": 8}
VOLUME = "synthetic-anomalous-00000"


@pytest.fixture(scope="module")
def jax_checkpoint(tmp_path_factory):
    """A JAX checkpoint of the tiny UNet (perturbed weights) under a fresh
    root; returns the root."""
    root = tmp_path_factory.mktemp("ckpt")
    _, params, _ = flax_and_port(CONFIGS["s2d1"], seed=3)
    args = defaultdict_from_json({**ARGS, "arg_num": "sw"})
    jckpt.save_checkpoint(str(root), args, 0, params, params,
                          optax.adamw(1e-4).init(params), final=True)
    return root


def read_rows(path):
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    return rows[0], np.array([[float(c) if c else np.nan for c in r]
                              for r in rows[1:]])


def patch_samplers(monkeypatch, batch):
    jsamp, tsamp = per_sample_bank_samplers((batch, 32, 32, 1))
    monkeypatch.setattr(jdetect, "sampler_from_args", lambda a: jsamp)
    monkeypatch.setattr(tdetect, "sampler_from_args", lambda a: tsamp)


@pytest.mark.parametrize("lambda_batch", [4, 3])
def test_graph_data_matches_jax(jax_checkpoint, monkeypatch, tmp_path, lambda_batch):
    """lambdas 0, 2, 5, 9 in one chunk of 4, or in chunks of 3 (the second
    padded with its first lambda)."""
    patch_samplers(monkeypatch, lambda_batch)
    out = {}
    for name, mod, kw in (("jax", jdetect, {}), ("port", tdetect, {"device": "cpu"})):
        root = tmp_path / name
        root.mkdir()
        os.symlink(jax_checkpoint / "model", root / "model")
        out[name] = mod.graph_data(root_dir=str(root), token="sw",
                                   lambdas=[0, 2, 5, 9], max_volumes=1,
                                   lambda_batch=lambda_batch, **kw)
    for j, w in zip(out["port"], out["jax"]):
        assert j["t"] == w["t"]
        for k in ("dice", "ssim", "iou", "auc"):
            assert abs(j[k] - w[k]) <= 1e-4, (k, j, w)
    for rel, tol in ((f"metrics/ARGS=sw/{VOLUME}.csv", 1e-4 + 5e-5),
                     ("metrics/argssw-lambda.csv", 1e-4)):
        gh, got = read_rows(tmp_path / "port" / rel)
        wh, want = read_rows(tmp_path / "jax" / rel)
        assert gh == wh and got.shape == want.shape == (4, len(gh))
        np.testing.assert_allclose(got, want, atol=tol, rtol=0, err_msg=rel)
    for name in ("port", "jax"):
        assert (tmp_path / name / "metrics" / "ARGS=sw" / f"{VOLUME}.png").exists()
        assert (tmp_path / name / "final-outputs" / "argssw-dice-lambda.png").exists()


def test_roc_data_matches_jax(jax_checkpoint, monkeypatch, tmp_path):
    patch_samplers(monkeypatch, 4)
    curves = {}
    for name, mod, kw in (("jax", jdetect, {}), ("port", tdetect, {"device": "cpu"})):
        root = tmp_path / name
        root.mkdir()
        os.symlink(jax_checkpoint / "model", root / "model")
        curves[name] = mod.roc_data(["sw"], root_dir=str(root), t_distance=10,
                                    max_volumes=1, **kw)
    (gf, gt), (wf, wt) = curves["port"]["argssw"], curves["jax"]["argssw"]
    from anoddpm_torch import metrics as tm
    assert abs(tm.auc(gf, gt) - tm.auc(wf, wt)) <= 1e-4
    gh, got = read_rows(tmp_path / "port" / "metrics" / "roc-comparison.csv")
    wh, want = read_rows(tmp_path / "jax" / "metrics" / "roc-comparison.csv")
    assert gh == wh == ["argssw_fpr", "argssw_tpr"] and got.shape == want.shape
    # one pixel's step: the curve's smallest non-zero increments
    step = np.array([np.diff(np.unique(wf))[0], np.diff(np.unique(wt))[0]])
    diff = np.abs(got - want)
    assert ((diff <= 1e-4) | (diff <= step + 1e-12)).all(), diff.max(axis=0)
    for name in ("port", "jax"):
        assert (tmp_path / name / "final-outputs" / "roc-comparison.png").exists()


def test_sharded_anomalous_metrics_matches_jax(jax_checkpoint, monkeypatch,
                                              tmp_path):
    """The JAX package's `sharded_anomalous_metrics` on a mesh of one device
    against the port's without a mesh: 4 slices in chunks of 3, so the
    second chunk is wrap-padded with 2 slices of the first; the
    reconstructions within 1e-5 and the same CSV text."""
    from anoddpm_tpu.parallel.mesh import make_mesh
    patch_samplers(monkeypatch, 3)
    recons, csvs = {}, {}
    for name, mod in (("jax", jdetect), ("port", tdetect)):
        real = mod.M.batched_anomaly_metrics

        def recording(images, recon, masks, real=real, name=name):
            recons[name] = np.array(recon)
            return real(images, recon, masks)

        monkeypatch.setattr(mod.M, "batched_anomaly_metrics", recording)
        root = tmp_path / name
        root.mkdir()
        os.symlink(jax_checkpoint / "model", root / "model")
        if name == "jax":
            args, em, sched = jdetect._load_eval_model(str(root), "sw")
            extra = (make_mesh(1),)
        else:
            args, em, sched = tdetect._load_eval_model(str(root), "sw",
                                                       device="cpu")
            extra = (None,)
        mod.sharded_anomalous_metrics(args, em, sched, *extra,
                                      root_dir=str(root), t_distance=10,
                                      max_volumes=1, chunk_per_device=3)
        csvs[name] = (root / "metrics" / "argssw.csv").read_text()
    assert recons["port"].shape == recons["jax"].shape == (4, 32, 32, 1)
    np.testing.assert_allclose(recons["port"], recons["jax"], atol=1e-5, rtol=0)
    assert csvs["port"] == csvs["jax"]
    assert csvs["port"].startswith("dice,ssim,iou,")


class TinyFlax(fnn.Module):
    """A one-layer stand-in for the UNet: eps = 0.1 conv1x1(x)."""

    @fnn.compact
    def __call__(self, x, t):
        return 0.1 * fnn.Conv(x.shape[-1], (1, 1))(x)


class TinyTorch(torch.nn.Module):
    def __init__(self, w):
        super().__init__()
        self.conv = torch.nn.Conv2d(1, 1, 1)
        with torch.no_grad():
            self.conv.weight.fill_(float(w[0]))
            self.conv.bias.fill_(float(w[1]))

    def forward(self, x, t):
        return 0.1 * self.conv(x)


@pytest.fixture(scope="module")
def stand_ins():
    module = TinyFlax()
    params = module.init(jax.random.key(0), jnp.zeros((1, 8, 8, 1)),
                         jnp.zeros((1,), jnp.int32))
    w = (float(params["params"]["Conv_0"]["kernel"].reshape(-1)[0]),
         float(params["params"]["Conv_0"]["bias"][0]))
    return EvalModel(module, params), TinyTorch(w).eval()


def tree(root):
    """Relative paths of every file under root, a .gif and an .mp4 of one
    name counted as one video."""
    out = set()
    for d, _, files in os.walk(root):
        for f in files:
            rel = os.path.relpath(os.path.join(d, f), root)
            out.add(rel[:-4] + ".video" if rel.endswith((".gif", ".mp4")) else rel)
    return out


def sweep_inputs():
    from anoddpm_torch.data.datasets import anomalous_dataset_from_args
    args = defaultdict_from_json({**ARGS, "T": 100, "arg_num": "ab"})
    sample = anomalous_dataset_from_args(".", args)[0]
    return args, sample["image"][1:2], sample["mask"][1:2]


@pytest.mark.parametrize("method", ["A", "octave", "gauss"])
def test_detection_methods_write_the_jax_artifacts(stand_ins, tmp_path, method):
    jem, tem = stand_ins
    args, x, mask = sweep_inputs()
    jsched = make_schedule(get_beta_schedule(100, "cosine"))
    tsched = ts.make_schedule(ts.get_beta_schedule(100, "cosine"))
    for root, mod, em, sched in ((tmp_path / "jax", jdetect, jem, jsched),
                                 (tmp_path / "port", tdetect, tem, tsched)):
        if method == "A":
            got = mod.detection_A(args, em, sched, x, mask, "vol-1",
                                  root_dir=str(root))
        else:
            got = mod.detection_B(args, em, sched, x, mask, "vol-1",
                                  denoise_fn=method, root_dir=str(root),
                                  total_avg=2)
            assert len(got) == 1 and 0 <= got[0] <= 1
    want = {"A": {f"diffusion-videos/ARGS=ab/Anomalous/vol-1/A/freq={i}-t=50.png"
                  for i in range(1, 8)},
            "octave": {"diffusion-videos/ARGS=ab/Anomalous/vol-1/octave/heatmap-t=50.png"},
            "gauss": {"diffusion-videos/ARGS=ab/Anomalous/vol-1/gauss/heatmap-t=50.png"}}
    assert tree(tmp_path / "port") == tree(tmp_path / "jax") == want[method]


def test_detection_A_fixedT_matches_jax_shape(stand_ins):
    jem, tem = stand_ins
    args, x, mask = sweep_inputs()
    want = jdetect.detection_A_fixedT(args, jem, make_schedule(get_beta_schedule(
        100, "cosine")), x, mask, end_freq=3, t_distance=20)
    got = tdetect.detection_A_fixedT(args, tem, ts.make_schedule(
        ts.get_beta_schedule(100, "cosine")), x, mask, end_freq=3, t_distance=20)
    assert got.shape == want.shape == (18, 32, 32, 1)
    assert np.isfinite(got).all()
    for row in range(3):          # x_0 and the mask rows are the inputs
        np.testing.assert_array_equal(got[6 * row], x[0])
        np.testing.assert_array_equal(got[6 * row + 5], mask[0])


def test_anomalous_validation_writes_the_jax_artifacts(stand_ins, tmp_path):
    """Two slices of one volume at T = sample_distance = 100: the timestep
    draw in [10, 60) quantises to 50 on both sides; a "whole"-sequence
    video and heatmap per slice, then method B's heatmap per slice."""
    jem, tem = stand_ins
    args, _, _ = sweep_inputs()
    args["sample_distance"] = 100
    dice = {}
    for name, mod, em, sched, kw in (
            ("jax", jdetect, jem, make_schedule(get_beta_schedule(100, "cosine")), {}),
            ("port", tdetect, tem, ts.make_schedule(ts.get_beta_schedule(100, "cosine")),
             {"device": "cpu"})):
        dice[name] = mod.anomalous_validation((args, em, sched),
                                              root_dir=str(tmp_path / name),
                                              max_slices=2, detection_avg=2, **kw)
    assert len(dice["port"]) == len(dice["jax"]) == 2
    base = f"diffusion-videos/ARGS=ab/Anomalous/{VOLUME}"
    want = {f"{base}/{s}/t=50.{ext}" for s in (0, 1) for ext in ("video", "png")}
    want |= {f"diffusion-videos/ARGS=ab/Anomalous/{VOLUME}-{s}/octave/heatmap-t=50.png"
             for s in (0, 1)}
    assert tree(tmp_path / "port") == tree(tmp_path / "jax") == want


def test_cli_modes_run_on_the_cpu(jax_checkpoint, monkeypatch, tmp_path, capsys):
    """Every mode of `python -m anoddpm_torch.detect` on the 32^2
    checkpoint at T = 20 (methods A and B sweep lambda >= 50 and so write
    nothing at this T)."""
    os.symlink(jax_checkpoint / "model", tmp_path / "model")
    monkeypatch.chdir(tmp_path)
    tdetect.main(["sw", "graph", "DENSE", "STEP=5", "VOLS=1", "LB=4"], device="cpu")
    header, rows = read_rows(tmp_path / "metrics" / "ARGS=sw" / f"{VOLUME}.csv")
    assert header == ["timestep", "Dice", "SSIM", "IOU", "Precision", "Recall", "FPR"]
    assert rows[:, 0].tolist() == [0, 5, 10, 15] and np.isfinite(rows).all()
    tdetect.main(["sw", "roc", "LESION=diffuse:1.5"], device="cpu")
    assert read_rows(tmp_path / "metrics" / "roc-comparison.csv")[0] == [
        "argssw_fpr", "argssw_tpr"]
    tdetect.main(["sw", "validation"], device="cpu")
    assert len([p for p in tree(tmp_path) if p.endswith("video")]) == 4
    tdetect.main(["sw", "methodA"], device="cpu")
    tdetect.main(["sw", "methodB"], device="cpu")
    assert "detection_B dice per lambda: []" in capsys.readouterr().out
    tdetect.main(["sw", "metrics", "VB=1"], device="cpu")
    assert (tmp_path / "metrics" / "argssw.csv").exists()
    for bad in (["sw", "graph", "NOPE"], ["sw", "methodA", "x"], ["sw", "VB"]):
        with pytest.raises(SystemExit):
            tdetect.main(bad, device="cpu")


def test_unported_sweep_parts_raise(jax_checkpoint, monkeypatch, tmp_path):
    """The parts that once raised run now: the context-encoder curve through
    the CLI (`CE=`, trained for 2 steps here on the checkpoint's own config),
    and the randParam noise through validation."""
    os.symlink(jax_checkpoint / "model", tmp_path / "model")
    monkeypatch.chdir(tmp_path)
    os.makedirs(tmp_path / "configs")
    import json
    with open(tmp_path / "configs" / "argssw.json", "w") as f:
        json.dump({**ARGS, "arg_num": "sw"}, f)
    from anoddpm_torch import baselines
    train_ce = baselines.train_context_encoder
    monkeypatch.setattr(baselines, "train_context_encoder",
                        lambda args, root_dir, steps, device: train_ce(
                            args, root_dir=root_dir, steps=2, batch_size=2,
                            base_channels=8, device=device))
    tdetect.main(["sw", "roc", "CE=sw"], device="cpu")
    header, rows = read_rows(tmp_path / "metrics" / "roc-comparison.csv")
    assert header == ["argssw_fpr", "argssw_tpr", "context-encoder_fpr",
                      "context-encoder_tpr"]
    assert (tmp_path / "metrics" / "argssw-ce.csv").exists()
    args = defaultdict_from_json({**ARGS, "arg_num": "rp",
                                  "noise_fn": "simplex_randParam"})
    dice = tdetect.anomalous_validation((args, TinyTorch((0.5, 0.0)), ts.make_schedule(
        ts.get_beta_schedule(T, "cosine"))), root_dir=str(tmp_path),
        max_volumes=1, max_slices=1, detection_avg=1)
    assert len(dice) == 1
    assert tdetect._auto_lambda_batch(256) == 32
    assert tdetect._auto_lambda_batch(32) == 128 and tdetect._auto_lambda_batch(1024) == 8
