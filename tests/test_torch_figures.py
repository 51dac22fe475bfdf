"""The port's paper figures against the JAX package's, at 32^2 on the CPU.

Both packages read one JAX checkpoint of the small UNet (T = 20, so every
lambda clamps to 20) and draw their noise from one numpy bank (their
`sampler_from_args` and `make_noise_sampler` patched in the figure and
detect modules).  Every generator runs on both sides; the sheets they save
are recorded (and written), the videos recorded without writing (the
card's machine may lack imageio).  Each generator must save the same file
names as the JAX package's, and each sheet and video must equal JAX's
arrays within the chains' tolerance (2e-4).  The context-encoder sheets
run on carried weights."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from anoddpm_tpu import checkpoint as jckpt
from anoddpm_tpu import detect as jdetect
from anoddpm_tpu import figures as jfig
from anoddpm_tpu import visualize as jvz
from anoddpm_tpu.config import defaultdict_from_json
from anoddpm_tpu.models import context_encoder as jce
from anoddpm_torch import detect as tdetect
from anoddpm_torch import figures as tfig
from anoddpm_torch import visualize as tvz
from anoddpm_torch.compat.flax_params import context_encoder_state_dict_from_flax
from anoddpm_torch.models import context_encoder as tce
from torch_parity import CONFIGS, T, bank_samplers, flax_and_port

ATOL = 2e-4
ARGS = {"img_size": [32, 32], "T": T, "beta_schedule": "cosine",
        "base_channels": 32, "channel_mults": "1 2",
        "attention_resolutions": "16", "noise_fn": "simplex",
        "dataset": "synthetic", "compute_dtype": "float32",
        "anomalous_volumes": 2, "Batch_Size": 2, "sample_distance": 8}
SMALL = {"ano": dict(n_attempts=1, rows=1), "masked_comparison": dict(n_volumes=2),
         "videos": dict(n_volumes=1)}


def run_side(pkg, root, monkeypatch):
    """Every generator of one package under root; {relative path: array}."""
    fig, det, vz = pkg
    jsamp, tsamp = bank_samplers((1, 32, 32, 1))
    sampler = jsamp if fig is jfig else tsamp
    for mod in (fig, det):
        monkeypatch.setattr(mod, "sampler_from_args", lambda a: sampler)
        monkeypatch.setattr(mod, "make_noise_sampler",
                            lambda *a, **k: sampler)
    saved = {}
    real = vz.save_grid_png

    def grid(path, images, row_size=-1, **kw):
        saved[os.path.relpath(path, root)] = np.asarray(images)
        real(path, images, row_size=row_size, **kw)

    def video(path, frames, row_size=-1, **kw):
        saved[os.path.relpath(path, root)] = np.stack(frames)

    monkeypatch.setattr(vz, "save_grid_png", grid)
    monkeypatch.setattr(vz, "save_video", video)
    kw = {} if fig is jfig else {"device": "cpu"}
    args, em, sched = det._load_eval_model(str(root), "fs", **kw)
    for name, fn in fig.GENERATORS.items():
        fn(args, em, sched, root_dir=str(root), **SMALL.get(name, {}))
    fig.test_set_outputs("fs", "fg", root_dir=str(root), n_attempts=1, **kw)
    fig.test_set_outputs("fs", "fg", root_dir=str(root), anomalous=True,
                         n_attempts=1, **kw)
    return saved


@pytest.fixture(scope="module")
def figures(tmp_path_factory):
    ckpt = tmp_path_factory.mktemp("figckpt")
    _, params, _ = flax_and_port(CONFIGS["s2d1"], seed=3)
    for token in ("fs", "fg"):
        jckpt.save_checkpoint(str(ckpt), defaultdict_from_json(
            {**ARGS, "arg_num": token}), 0, params, params,
            optax.adamw(1e-4).init(params), final=True)
    out = {}
    mp = pytest.MonkeyPatch()
    try:
        for name, pkg in (("jax", (jfig, jdetect, jvz)),
                          ("port", (tfig, tdetect, tvz))):
            root = tmp_path_factory.mktemp(name)
            os.symlink(ckpt / "model", root / "model")
            out[name] = (run_side(pkg, root, mp), root)
            mp.undo()
    finally:
        mp.undo()
    return out


EXPECTED = {
    "sequence": ["final-outputs/ARGS=fs-sequence.png"],
    "masked_comparison": ["final-outputs/ARGS=fs-masked-comparison.png"],
    "videos": ["final-outputs/ARGS=fs-video-0.mp4"],
    "ano": ["final-outputs/ARGS=fs/attempt=1-0.5-predictions.png",
            "final-outputs/ARGS=fs/attempt=1-0.5-sequence.png"],
    "gauss_simplex": ["final-outputs/ARGS=fs-gauss-vs-simplex.png"],
    "varying_frequency": ["final-outputs/ARGS=fs-varying-frequency.png"],
    "varying_t": ["final-outputs/ARGS=fs-gauss-varyingT.png"],
    "test_set": ["final-outputs/ARGS=fs/test_set_mixed_attempt=1-sequence.png"],
}


def test_every_generator_saves_the_jax_names(figures):
    (got, groot), (want, wroot) = figures["port"], figures["jax"]
    assert sorted(got) == sorted(want)
    assert sorted(got) == sorted(p for ps in EXPECTED.values() for p in ps)
    for rel in got:
        if rel.endswith(".png"):
            assert (groot / rel).exists() and (wroot / rel).exists(), rel


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_generator_arrays_match_jax(figures, name):
    got, want = figures["port"][0], figures["jax"][0]
    for rel in EXPECTED[name]:
        assert got[rel].shape == want[rel].shape, rel
        np.testing.assert_allclose(got[rel], want[rel], atol=ATOL, rtol=0,
                                   err_msg=rel)


def test_make_prediction_matches_jax():
    rng = np.random.default_rng(0)
    real, recon, x_t = (rng.uniform(-1, 1, (2, 8, 8, 1)).astype(np.float32)
                        for _ in range(3))
    mask = (rng.uniform(size=(2, 8, 8, 1)) > 0.5).astype(np.float32)
    for error_fn in ("sq", "l1"):
        got = tfig.make_prediction(real, recon, mask, x_t, 0.3, error_fn)
        want = jfig.make_prediction(real, recon, mask, x_t, 0.3, error_fn)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, np.asarray(w))
    np.testing.assert_array_equal(tfig._mirror_indices(41, 6),
                                  jfig._mirror_indices(41, 6))


def test_ce_sheets_match_jax(tmp_path, monkeypatch):
    fmodel = jce.ContextEncoder(base_channels=8)
    params = fmodel.init(jax.random.key(1), jnp.zeros((1, 32, 32, 1)),
                         jnp.zeros((1, 32, 32, 1)))
    port = tce.ContextEncoder(in_channels=1, base_channels=8)
    port.load_state_dict(context_encoder_state_dict_from_flax(params))
    port.eval()
    saved = {}
    for name, vz in (("jax", jvz), ("port", tvz)):
        real = vz.save_grid_png
        monkeypatch.setattr(vz, "save_grid_png",
                            lambda path, images, row_size=-1, _n=name, _r=real, **k:
                            (saved.setdefault(_n, {}).__setitem__(
                                os.path.basename(path), np.asarray(images)),
                             _r(path, images, row_size=row_size, **k)))
    args = defaultdict_from_json({**ARGS, "arg_num": "ce"})
    jfig.ce_outputs(args, fmodel, params, root_dir=str(tmp_path / "jax"),
                    n_attempts=1, rows=2)
    tfig.ce_outputs(args, port, root_dir=str(tmp_path / "port"),
                    n_attempts=1, rows=2)
    assert sorted(saved["port"]) == sorted(saved["jax"]) == [
        "ce-attempt=1-predictions.png"]
    # the inpainting agrees within 1e-5 (test_torch_context_encoder.py);
    # the square-error panel, 2 (recon - x)^2, scales that by up to 8
    for k in saved["jax"]:
        np.testing.assert_allclose(saved["port"][k], saved["jax"][k],
                                   atol=ATOL, rtol=0)
    assert (tmp_path / "port" / "final-outputs" / "ARGS=ce" /
            "ce-attempt=1-predictions.png").exists()


def test_cli_rejects_unknown_figures(monkeypatch):
    with pytest.raises(SystemExit):
        tfig.main([])
    with pytest.raises(SystemExit):
        tfig.main(["fs", "nope"], device="cpu")
    with pytest.raises(SystemExit):
        tfig.main(["fs", "test_set"], device="cpu")
