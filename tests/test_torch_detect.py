"""The port's detection path against the JAX package: evaluate_anomaly_batch
with converted weights and injected noise, the metrics copy, checkpoints
written by the JAX package, and the CSV contract of the entry point."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from anoddpm_tpu import checkpoint as jckpt
from anoddpm_tpu import detect as jdetect
from anoddpm_tpu import metrics as jmetrics
from anoddpm_tpu.config import defaultdict_from_json
from anoddpm_tpu.data.synthetic import SyntheticAnomalyDataset as JaxSynthetic
from anoddpm_tpu.schedule import get_beta_schedule, make_schedule
from anoddpm_tpu.training import EvalModel
from anoddpm_torch import checkpoint as tckpt
from anoddpm_torch import detect as tdetect
from anoddpm_torch import metrics as tmetrics
from anoddpm_torch import schedule as ts
from anoddpm_torch.data.datasets import anomalous_dataset_from_args
from anoddpm_torch.models.unet import UNet
from torch_parity import CONFIGS, T, bank_samplers, flax_and_port, port_apply

ARGS = {"img_size": [32, 32], "T": T, "beta_schedule": "cosine",
        "base_channels": 32, "channel_mults": "1 2",
        "attention_resolutions": "16", "noise_fn": "simplex",
        "dataset": "synthetic", "compute_dtype": "float32"}
METRICS = ("dice", "ssim", "iou", "precision", "recall", "fpr", "auc")


def volume():
    sample = anomalous_dataset_from_args(".", defaultdict_from_json(
        {"img_size": (32, 32)}))[0]
    want = JaxSynthetic(img_size=(32, 32))[0]
    np.testing.assert_array_equal(sample["image"], want["image"])
    np.testing.assert_array_equal(sample["mask"], want["mask"])
    return sample["image"], sample["mask"]


@pytest.mark.parametrize("kind", ["bump", "diffuse"])
def test_synthetic_volumes_equal_jax(kind):
    args = defaultdict_from_json({"img_size": (32, 32), "lesion_kind": kind,
                                  "anomalous_volumes": 3})
    got = anomalous_dataset_from_args(".", args)
    want = JaxSynthetic(img_size=(32, 32), length=3, lesion_kind=kind)
    assert len(got) == len(want) == 3
    for i in range(3):
        for field in ("image", "mask"):
            np.testing.assert_array_equal(got[i][field], want[i][field])
        assert got[i]["filenames"] == want[i]["filenames"]


def test_evaluate_anomaly_batch_matches_jax():
    jsched = make_schedule(get_beta_schedule(T, "cosine"))
    tsched = ts.make_schedule(ts.get_beta_schedule(T, "cosine"))
    fmodel, params, port = flax_and_port(CONFIGS["s2d1"])
    images, masks = volume()
    jsamp, tsamp = bank_samplers(images.shape)
    want, wrecon = jdetect.evaluate_anomaly_batch(
        EvalModel(fmodel, params), jsched, images, masks, jax.random.key(0),
        jsamp, t_distance=10)
    got, grecon = tdetect.evaluate_anomaly_batch(
        port, tsched, images, masks, torch.Generator(), tsamp, t_distance=10)
    assert grecon.shape == images.shape
    np.testing.assert_allclose(grecon, wrecon, atol=2e-4)
    np.testing.assert_allclose(got["auc"], want["auc"], atol=1e-3)
    for k in METRICS[:-1]:
        np.testing.assert_allclose(got[k], want[k], atol=1e-2, err_msg=k)


def test_metrics_copy_equals_jax():
    images, masks = volume()
    recon = images + np.random.default_rng(4).normal(0, 0.6, images.shape)
    want = jmetrics.batched_anomaly_metrics(images, recon, masks)
    got = tmetrics.batched_anomaly_metrics(images, recon, masks)
    for k in METRICS:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_jax_checkpoint_loads_into_port(tmp_path):
    """A checkpoint written by the JAX package (flax msgpack, optax state
    included) loads through the port and gives the same UNet outputs."""
    fmodel, params, _ = flax_and_port(CONFIGS["s2d1"], seed=1)
    ema = jax.tree_util.tree_map(lambda p: p * 0.5, params)
    args = defaultdict_from_json({**ARGS, "arg_num": "jx"})
    opt = optax.adamw(1e-4).init(params)
    jckpt.save_checkpoint(str(tmp_path), args, 3, params, ema, opt, final=True)
    jckpt.save_checkpoint(str(tmp_path), args, 3, params, ema, opt)
    x = np.random.default_rng(2).normal(size=(1, 32, 32, 1)).astype(np.float32)
    want = jax.jit(fmodel.apply)(ema, jnp.asarray(x), jnp.asarray([4], jnp.int32))
    for use_ckpt in (False, True):
        largs, payload, meta = tckpt.load_parameters(str(tmp_path), "argsjx",
                                                     use_checkpoint=use_ckpt)
        assert largs["arg_num"] == "jx" and meta["n_epoch"] == 3
        port = UNet(**CONFIGS["s2d1"])
        port.load_state_dict(payload["ema"])
        np.testing.assert_allclose(port_apply(port.eval(), x, [4]),
                                   np.asarray(want), atol=2e-4)


def test_port_checkpoint_resume_skips_corrupt(tmp_path):
    port = UNet(**CONFIGS["s2d1"])
    sd = port.state_dict()
    args = defaultdict_from_json({**ARGS, "arg_num": "rs"})
    tckpt.save_checkpoint(str(tmp_path), args, 1, sd, sd)
    newest = tckpt.save_checkpoint(str(tmp_path), args, 2, sd, sd)
    with open(os.path.join(newest, "payload.msgpack"), "wb") as f:
        f.write(b"\x00garbage")
    payload, meta = tckpt.load_checkpoint(str(tmp_path), "rs",
                                          use_checkpoint=True)
    assert meta["n_epoch"] == 1
    for k, v in sd.items():
        assert torch.equal(payload["ema"][k], v), k


def test_metric_calculation_writes_csv(tmp_path):
    """The normal entry path on the CPU: a port checkpoint, the synthetic
    anomalous set, simplex noise, lambda clamped to T."""
    port = UNet(**CONFIGS["s2d1"])
    sd = port.state_dict()
    args = defaultdict_from_json({**ARGS, "arg_num": "csv", "T": 6})
    tckpt.save_checkpoint(str(tmp_path), args, 0, sd, sd, final=True)
    summary = tdetect.anomalous_metric_calculation(
        token="csv", root_dir=str(tmp_path), max_volumes=1, device="cpu")
    assert all(np.isfinite(summary[k]) for k in METRICS)
    with open(tmp_path / "metrics" / "argscsv.csv") as f:
        header, row = f.read().splitlines()
    assert header == "dice,ssim,iou,precision,recall,fpr,auc"
    cells = row.rstrip(",").split(",")
    assert len(cells) == 7 and all(" +- " in c for c in cells)
    assert float(cells[-1].split(" +- ")[0]) == round(summary["auc"], 4)


def test_unported_parts_raise(tmp_path):
    """DDIM, the sweep modes and the real-data families name their ROADMAP
    item instead of running something else."""
    port = UNet(**CONFIGS["s2d1"]).eval()
    sched = ts.make_schedule(ts.get_beta_schedule(T, "cosine"))
    ddim = defaultdict_from_json({**ARGS, "arg_num": "dd", "sampler": "ddim"})
    with pytest.raises(NotImplementedError, match="ROADMAP.*DDIM"):
        tdetect.anomalous_metric_calculation(
            ddim, root_dir=str(tmp_path), em=port, sched=sched, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP.*sweeps"):
        tdetect.main(["1", "graph"])
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        anomalous_dataset_from_args(".", defaultdict_from_json(
            {"img_size": (32, 32), "dataset": "mri"}))


def test_metric_calculation_repeats_and_volume_batch(tmp_path):
    port = UNet(**CONFIGS["s2d1"]).eval()
    sched = ts.make_schedule(ts.get_beta_schedule(T, "cosine"))
    base = {**ARGS, "arg_num": "vb", "noise_fn": "gauss",
            "anomalous_volumes": 2}
    one = tdetect.anomalous_metric_calculation(
        defaultdict_from_json(base), root_dir=str(tmp_path), em=port,
        sched=sched, t_distance=3, volume_batch=2, device="cpu")
    two = tdetect.anomalous_metric_calculation(
        defaultdict_from_json({**base, "recon_repeats": 2}),
        root_dir=str(tmp_path), em=port, sched=sched, t_distance=3,
        device="cpu")
    assert np.isfinite(one["auc"]) and np.isfinite(two["auc"])
    assert one != two
