"""The 3-way ROC campaign (`anoddpm_torch.campaigns.roc_3way`).

- Its paired verdict reaches each branch on hand-made AUC sets.
- Reading the JAX package's committed curves
  (`results/roc_3way_diffuse_sev1.5.csv`) gives the AUCs its log printed.
- At 32^2 on the JAX streams, the campaign's detection-CLI call (two
  diffusion checkpoints, `CE=`, `LESION=diffuse:1.5`) against the JAX
  package's CLI on the same arguments: every draw's key equals the one the
  JAX code splits off for it, each model's scores stand against JAX's by
  `RECON_RULE` of `tests/test_torch_jax_streams.py` (its noise kind's
  rule), and the AUCs within the bounds of the suite's ROC test.  Both
  CLIs run with the context encoder cut to 3 steps (`roc_data` wrapped);
  everything else is the CLI's.
- The two training recipes, `--paired` on fixture CSVs, and `--ce-spread`'s
  settings.
"""
import functools
import json
import os
import shutil

import jax
import numpy as np
import pytest

from anoddpm_tpu import detect as jdetect
from anoddpm_torch import detect as tdetect
from anoddpm_torch import metrics as tm
from anoddpm_torch.campaigns import roc_3way
from anoddpm_torch.campaigns.seed_replication import SUBSTEPS
from test_torch_jax_streams_suite import (  # noqa: F401 (fixtures)
    T_SHORT, _chains, _ce_config, _hold, _record, _write_checkpoints, drawn,
    models, words)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX = {"simplex": 0.7429, "gauss": 0.4317, "ce": 0.7508}


@pytest.mark.parametrize("port,verdict", [
    ({"simplex": 0.7480, "gauss": 0.4250, "ce": 0.7440}, "closed: the ROC pairs"),
    ({"simplex": 0.7280, "gauss": 0.4450, "ce": 0.7360}, "open: the curves part"),
    ({"simplex": 0.7429, "gauss": 0.3500, "ce": 0.7508},
     "a fault in the port: the simplex - Gaussian gap"),
    ({"simplex": 0.7900, "gauss": 0.5100, "ce": 0.8000},
     "a fault in the port: the Gaussian curve across .5"),
    ({"simplex": 0.7429, "gauss": 0.4317, "ce": 0.8100},
     "a fault in the port: the context encoder - simplex difference"),
])
def test_paired_verdict_branches(port, verdict):
    out = roc_3way.paired_verdict(port, JAX)
    assert out["verdict"] == verdict, out
    assert out["delta"] == pytest.approx({k: port[k] - JAX[k] for k in JAX})


def test_the_jax_file_gives_the_logged_aucs():
    """The trapezoid of each reduced curve of the committed CSV against the
    AUCs of `results/roc_diffuse_sev1.5.log` (.7429, .4317, .7508)."""
    stats = roc_3way.curve_stats(roc_3way.read_curves(
        os.path.join(REPO, roc_3way.JAX_CSV)))
    for which, (label, _) in roc_3way.CURVES.items():
        assert abs(stats[label][0] - JAX[which]) <= 1e-4, (which, stats[label][0])
        assert len(stats[label][1]) == len(roc_3way.TPR_AT)


def test_training_recipes():
    """Seed 0 of the band recipe and the Gaussian config as the JAX trainer
    takes it, both on the JAX streams in the flax order, the test-set suite
    off."""
    s = roc_3way.model_args("simplex", REPO)
    g = roc_3way.model_args("gauss", REPO)
    assert s["arg_num"] == "256syn64s2d_s0_jaxrng" and s["seed"] == 0
    assert s["train_substeps"] == SUBSTEPS and s["noise_fn"] == "simplex"
    assert g["arg_num"] == "256syn64s2dg_jaxrng" and g["noise_fn"] == "gauss"
    assert not g["train_substeps"]          # 1 step a dispatch
    for a in (s, g):
        assert (a["rng"], a["norm_impl"], a["bf16_norm"], a["pallas_norm"],
                a["skip_test_eval"]) == ("jax", "flax", False, False, True)
        assert int(a["EPOCHS"]) == 600 and a["space_to_depth"] == 2


def test_cli_roc_matches_jax(models, drawn, monkeypatch, tmp_path):
    """Two volumes of diffuse lesions at severity 1.5, lambda T_SHORT:
    key(13) split once per volume for each model, the simplex model's
    chains drawing seeds, the Gaussian model's normals; then the context
    encoder from flax's init of key(0), 3 steps on key(1) split once a
    step, each step's box rows and columns drawn from a split of that
    step's key."""
    import warnings
    warnings.simplefilter("ignore")
    _write_checkpoints(tmp_path, models, {"s": "simplex", "g": "gauss"})
    _ce_config(tmp_path)
    argv = roc_3way.roc_argv("s", "g", "ce")
    assert argv == ["s", "roc", "g", "CE=ce", "LESION=diffuse:1.5"]
    scores = {"jax": [], "port": []}
    seen = {"jax": [], "port": []}
    for name, mod in (("jax", jdetect), ("port", tdetect)):
        _record(monkeypatch, mod.M, "roc_curve", scores[name],
                lambda labels, s: np.asarray(s))
        _record(monkeypatch, mod, "roc_data", seen[name],
                lambda tokens, **kw: (tokens, kw["ce_token"], kw["args_override"]))
        cut = getattr(mod, "roc_data")
        monkeypatch.setattr(mod, "roc_data", functools.partial(
            cut, max_volumes=2, ce_train_steps=3))
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        jdetect.main(list(argv))
    finally:
        os.chdir(cwd)
    jax_csv = tmp_path / "metrics" / "roc-comparison.csv"
    shutil.move(jax_csv, tmp_path / "jax.csv")
    roc_3way.score(str(tmp_path), argv, device="cpu")
    assert seen["port"] == seen["jax"] == [
        (["s", "g"], "ce", {"lesion_kind": "diffuse", "lesion_severity": 1.5})]
    want = []
    for kind in ("simplex", "gauss"):
        want += _chains(jax.random.key(13), 2, T_SHORT, fwd_kind=kind,
                        rev_kind=kind)[1]
    key = jax.random.key(1)
    for _ in range(3):
        key, sub = jax.random.split(key)
        want += [words(k) for k in jax.random.split(sub)]
    assert drawn == want
    _hold(scores["jax"][0], scores["port"][0], "simplex")
    _hold(scores["jax"][1], scores["port"][1], "gauss")
    curves = {"jax": roc_3way.read_curves(str(tmp_path / "jax.csv")),
              "port": roc_3way.read_curves(str(jax_csv))}
    assert sorted(curves["port"]) == sorted(curves["jax"]) == [
        "argsg", "argss", "context-encoder"]
    for label in curves["jax"]:
        auc = [tm.auc(*curves[n][label]) for n in ("jax", "port")]
        assert abs(auc[0] - auc[1]) <= (1e-3 if label == "context-encoder"
                                        else 1e-2), (label, auc)


@pytest.mark.parametrize("port_dir", [None, roc_3way.OUT_DIR + "/run_b"])
def test_paired_main_on_fixture_csvs(tmp_path, port_dir):
    """--paired with the JAX file's curves relabelled as the port's: every
    delta 0, "closed: the ROC pairs", the TPRs of both sides equal; the
    record names the CSV it read (--port-dir) and is written to --out."""
    src = os.path.join(REPO, roc_3way.JAX_CSV)
    read_dir = port_dir or roc_3way.OUT_DIR
    os.makedirs(tmp_path / read_dir)
    os.makedirs(tmp_path / "results", exist_ok=True)
    shutil.copy(src, tmp_path / roc_3way.JAX_CSV)
    with open(src) as f:
        text = f.read()
    for jax_label, port_label in roc_3way.CURVES.values():
        text = text.replace(f"{jax_label}_", f"{port_label}_")
    with open(tmp_path / read_dir / roc_3way.CSV_NAME, "w") as f:
        f.write(text)
    argv, written = ["--paired", "--root", str(tmp_path)], roc_3way.ROC_3WAY_JAX_RNG_PAIRED
    if port_dir is not None:
        written = os.path.join(port_dir, "paired.json")
        argv += ["--port-dir", port_dir, "--out", written]
    out = roc_3way.main(argv)
    assert out["verdict"] == "closed: the ROC pairs"
    assert all(d == 0 for d in out["delta"].values())
    assert out["tpr_at_fpr"]["port"] == out["tpr_at_fpr"]["jax"]
    with open(tmp_path / written) as f:
        record = json.load(f)
    assert record["verdict"] == out["verdict"]
    assert record["port_csv"] == os.path.join(read_dir, roc_3way.CSV_NAME)


def test_ce_spread_sets_and_restores_the_flags(tmp_path, monkeypatch):
    """--ce-spread runs the CE's stage `repeats` times under each setting
    with cuDNN's flags as `CE_SETTINGS` name them, records them, and leaves
    the process's flags as it found them (the stage itself is stubbed)."""
    import torch
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    before = (cudnn.deterministic, cudnn.allow_tf32, matmul.allow_tf32)
    seen = []
    monkeypatch.setattr(roc_3way, "ce_auc", lambda root, device: seen.append(
        (cudnn.deterministic, cudnn.allow_tf32, matmul.allow_tf32)) or 0.7 + len(seen) / 100)
    os.makedirs(tmp_path / "configs")
    shutil.copy(os.path.join(REPO, "configs", f"args{roc_3way.CE_CONFIG}.json"),
                tmp_path / "configs")
    res = roc_3way.main(["--ce-spread", "2", "--root", str(tmp_path), "--device", "cpu"])
    assert (cudnn.deterministic, cudnn.allow_tf32, matmul.allow_tf32) == before
    assert seen == [before] * 2 + [(True,) + before[1:]] * 2 + [(True, False, False)] * 2
    assert list(res) == list(roc_3way.CE_SETTINGS)
    for i, name in enumerate(res):
        assert res[name]["auc"] == pytest.approx([0.71 + 0.02 * i, 0.72 + 0.02 * i])
        assert res[name]["spread"] == pytest.approx(0.01)
        assert res[name]["flags"]["cudnn_deterministic"] == seen[2 * i][0]
    with open(tmp_path / roc_3way.ROC_3WAY_CE_SPREAD) as f:
        assert json.load(f) == json.loads(json.dumps(res))
