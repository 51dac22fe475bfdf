"""args256syn128, the paper's configuration, on the JAX package's streams:
the tooling that trains, gates and pairs its seeds.

- `seed_replication.train_args_for("256syn128", S, root, "jax_rng")` is
  the JAX script's recipe (`scripts/seed_replication.py`: the config, seed
  S, 8 substeps) plus the flax norm order with `bf16_norm` and
  `pallas_norm` off and `rng: "jax"`; `--rng jax` with the s2d64 cells
  skipped writes `results/torch_jax_rng_256syn128_seeds<S>.json` and
  never the s2d64 files, and a JAX-stream run that keeps both configs is
  refused.
- The epoch-0 gate (`scripts/torch_jax_streams_epoch0.py`): each log line
  it cites holds the loss and VLB it quotes; `--config 256syn128 --small
  --jax-side` gives the port's epoch-0 loss and VLB within 1e-4 relative
  of the JAX trainer's (the rule of `test_train_draws_and_matches_the_
  jax_trainer`; 1.4e-5 and 2.9e-5 measured for seed 0).
- `band --jax-rng --config 256syn128` on fixture files takes each verdict
  branch of the rule of PERF.md section 2 and computes no P1; the s2d64
  paired file recomputes byte for byte from its committed inputs.
- `roc_3way --ce-mean`: the CE's mean over fresh default runs against the
  JAX file's AUC (`ce_mean_verdict`), written to its own file.
"""
import importlib.util
import json
import os
import pathlib
import shutil
import subprocess
import sys
from unittest import mock

import numpy as np
import pytest

from anoddpm_torch.campaigns import band, roc_3way, seed_replication
from anoddpm_torch.campaigns._results import (ROC_3WAY_CE_MEAN,
                                              ROC_3WAY_CE_SPREAD,
                                              load_results, save_results)

ROOT = pathlib.Path(__file__).resolve().parent.parent
CELL = "paper128_ddpm200"


def _load_script(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    with mock.patch.dict(os.environ):
        spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_script():
    """scripts/seed_replication.py, the script that trained the JAX five."""
    return _load_script("jax_seed_replication_paper",
                        ROOT / "scripts" / "seed_replication.py")


@pytest.fixture(scope="module")
def gate_script():
    return _load_script("torch_jax_streams_epoch0",
                        ROOT / "scripts" / "torch_jax_streams_epoch0.py")


# --- the recipe and the seeds' files ------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
def test_paper_recipe_is_the_jax_scripts(jax_script, seed):
    ours = seed_replication.train_args_for("256syn128", seed, str(ROOT),
                                           "jax_rng")
    theirs = jax_script.train_args_for("256syn128", seed)
    assert (ours["seed"], ours["train_substeps"]) == (seed, 8)
    assert (ours["norm_impl"], ours["bf16_norm"], ours["pallas_norm"],
            ours["rng"]) == ("flax", False, False, "jax")
    assert ours["arg_num"] == theirs["arg_num"] + "_jaxrng"
    added = {"norm_impl", "bf16_norm", "pallas_norm", "rng", "arg_num"}
    for k, v in theirs.items():
        if k not in added:
            assert ours[k] == v, k


def _stub_campaign():
    trained = []

    def ensure(config, seed, root, device, order, skip_test_eval=False):
        trained.append((config, seed, order, skip_test_eval))
        return f"{config}_s{seed}"

    def metric(args, root_dir, em, sched, device):
        return {m: 0.5 for m in seed_replication.METRICS}

    patches = (mock.patch.object(seed_replication, "ensure_trained", ensure),
               mock.patch.object(seed_replication, "_load_eval_model",
                                 lambda r, t, device: ({}, None, None)),
               mock.patch.object(seed_replication,
                                 "anomalous_metric_calculation", metric))
    return trained, patches


def test_paper_seeds_write_their_own_file(tmp_path):
    """`--rng jax --skip=s2d64,_diffuse --skip-test-eval` trains 256syn128
    alone without the test-set suite, scores `paper128_ddpm200` alone and
    writes the paper's file, no s2d64 file."""
    trained, patches = _stub_campaign()
    with patches[0], patches[1], patches[2]:
        res = seed_replication.main(["3", "--skip=s2d64,_diffuse", "--rng",
                                     "jax", "--norm-order", "flax", "--own-file",
                                     "--skip-test-eval", "--root", str(tmp_path)],
                                    device="cpu")
    assert trained == [("256syn128", 3, "jax_rng", True)]
    assert sorted(res) == [f"{CELL}/aggregate", f"{CELL}/seed3"]
    assert load_results(str(tmp_path),
                        "results/torch_jax_rng_256syn128_seeds3.json") == res
    assert os.listdir(tmp_path / "results") == ["torch_jax_rng_256syn128_seeds3.json"]
    assert seed_replication.results_name([3], "jax_rng", config="256syn128") \
        == "results/torch_jax_rng_256syn128_seeds3.json"
    assert seed_replication.results_name([3], "jax_rng") \
        == "results/torch_f3_jax_rng_seeds3.json"


@pytest.mark.parametrize("skip", [False, True])
def test_ensure_trained_skips_the_test_set_suite(tmp_path, skip):
    """`skip_test_eval` reaches the trainer's args, and nothing else moves."""
    seen = []
    with mock.patch.object(seed_replication, "train",
                           lambda args, root_dir, device: seen.append(args)):
        token = seed_replication.ensure_trained("256syn128", 2, str(ROOT), "cpu",
                                                "jax_rng", skip_test_eval=skip)
    want = seed_replication.train_args_for("256syn128", 2, str(ROOT), "jax_rng")
    if skip:
        want["skip_test_eval"] = True
    assert token == "256syn128_s2_jaxrng" and seen == [want]


def test_jax_rng_run_of_both_configs_is_refused(tmp_path):
    """Each config's JAX-stream seeds have a file of their own, so a run
    that keeps the cells of both is refused before it trains anything."""
    trained, patches = _stub_campaign()
    with patches[0], patches[1], patches[2], pytest.raises(ValueError):
        seed_replication.main(["3", "--rng", "jax", "--root", str(tmp_path)],
                              device="cpu")
    assert trained == []


# --- the epoch-0 gate -----------------------------------------------------------

@pytest.mark.parametrize("config,seed", [(c, s) for c in ("256syn64s2d",
                                                          "256syn128")
                                         for s in range(5)])
def test_gate_logs_cite_their_lines(gate_script, config, seed):
    """Each (file:line, loss, VLB) of the gate's LOGS is the TPU log's
    epoch-0 line of that seed, as printed there."""
    where, loss, vlb = gate_script.LOGS[config][seed]
    path, line = where.split(":")
    with open(ROOT / path) as f:
        text = f.read().splitlines()[int(line) - 1]
    assert text.startswith(f"epoch: 0, loss: {loss:.5f}, total VLB: {vlb:.4f} ")


def test_gate_small_paper_matches_the_jax_trainer(tmp_path):
    """`--config 256syn128 --small --jax-side` (in a subprocess, JAX on the
    CPU): seed 0's epoch 0 at 32^2 through the port and the JAX trainer,
    the loss and the VLB within 1e-4 relative."""
    out = tmp_path / "gate.json"
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    proc = subprocess.run(
        [sys.executable, str(ROOT / "scripts" / "torch_jax_streams_epoch0.py"),
         "--config", "256syn128", "--small", "--jax-side", "--device", "cpu",
         "--seeds", "0", "--settings", "default", "--root", str(tmp_path / "run"),
         "--out", str(out)], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=600)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    with open(out) as f:
        got = json.load(f)
    assert (got["config"], got["small"]) == ("256syn128", True)
    row = got["seeds"]["0"]["tried"]["default"]
    assert row["loss"] == pytest.approx(row["jax_cpu"]["loss"], rel=1e-4)
    assert row["vlb"] == pytest.approx(row["jax_cpu"]["vlb"], rel=1e-4)
    assert "peak_gib" not in row and row["vlb_sweep_seconds"] > 0


# --- band --jax-rng --config 256syn128 -----------------------------------------

def _jax_seeds():
    with open(ROOT / "results" / "seed_replication.json") as f:
        return json.load(f)


def _paper_fixture(root, port_of, paired=(0, 1, 2, 3, 4)):
    """The paper's JAX-stream seed files, one per seed, whose value in each
    metric is `port_of(metric, seed, jax_value)`, and the paper's gate."""
    jax = _jax_seeds()
    for s in range(5):
        save_results(str(root), f"results/torch_jax_rng_256syn128_seeds{s}.json", {
            f"{CELL}/seed{s}": {m: port_of(m, s, jax[f"{CELL}/seed{s}"][m])
                                for m in ("auc", "dice", "iou", "ssim")}})
    save_results(str(root), band.EPOCH0_GATES["256syn128"], {"seeds": {
        str(s): {"paired": s in paired} for s in range(5)}})


@pytest.mark.parametrize("case,verdict", [
    ("twins", "closed: the draws"),
    ("offset", "a fault in the port: paired t"),
    ("shuffled", "open: the pairs do not hold"),
    ("three", "open: the streams could not be reproduced"),
    ("untrained", "open: the streams could not be reproduced")])
def test_band_paper_paired_verdicts(tmp_path, case, verdict):
    """Twins a hair from their JAX seed close it; every seed .01 above its
    twin (a level the paired t-test sees, half a JAX sigma) is a fault;
    each seed handed another seed's values carries nothing (mean|d| over
    sigma_JAX 1.09 and 1.22, median 1.156); three gated seeds leave it
    open, and so do five gated seeds of which three were trained.  No P1:
    F3's cell is not the paper's."""
    jax = _jax_seeds()

    def port_of(metric, seed, value):
        if case == "shuffled":
            return jax[f"{CELL}/seed{(seed + 2) % 5}"][metric]
        if case == "offset":
            return value + 0.01 + 1e-4 * (seed - 2)
        return value + 1e-4 * (seed - 2)

    _paper_fixture(tmp_path, port_of,
                   (0, 1, 3) if case == "three" else (0, 1, 2, 3, 4))
    if case == "untrained":
        for s in (2, 4):
            os.remove(tmp_path / "results"
                      / f"torch_jax_rng_256syn128_seeds{s}.json")
    out = band.main(["--root", str(tmp_path), "--jax-rng", "--config",
                     "256syn128"])
    assert load_results(str(tmp_path),
                        "results/torch_jax_rng_256syn128_paired.json") \
        == json.loads(json.dumps(out))
    assert out["verdict"].startswith(verdict)
    assert "p1" not in out and list(out["cells"]) == [CELL]
    row = out["cells"][CELL]["auc"]
    assert set(row) >= {"mean", "max_abs", "pearson_r", "paired_t_p",
                        "sigma_jax", "mean_abs_over_sigma"}
    assert out["cells"][CELL]["seeds"] == ([0, 1, 3] if case in ("three", "untrained")
                                           else [0, 1, 2, 3, 4])
    assert sorted(out["holm"]) == [f"{CELL}/auc", f"{CELL}/dice"]
    if case == "shuffled":
        assert out["median_mean_abs_over_sigma"] == pytest.approx(1.156, abs=1e-3)
    assert not os.path.exists(tmp_path / "results" / "torch_f3_jax_rng_paired.json")


def test_s2d64_paired_file_recomputes_equal(tmp_path):
    """`band --jax-rng` (256syn64s2d, the default) writes, from the
    committed seed files and gate, the committed paired file byte for byte,
    P1 and all."""
    names = [p.name for p in (ROOT / "results").glob("torch_f3_jax_rng_seeds*.json")]
    assert len(names) == 5
    os.makedirs(tmp_path / "results")
    for name in names + ["torch_jax_streams_epoch0.json"]:
        shutil.copy(ROOT / "results" / name, tmp_path / "results" / name)
    band.main(["--root", str(tmp_path), "--jax-rng"])
    with open(tmp_path / "results" / "torch_f3_jax_rng_paired.json", "rb") as f:
        got = f.read()
    with open(ROOT / "results" / "torch_f3_jax_rng_paired.json", "rb") as f:
        assert got == f.read()


# --- the CE's mean over fresh runs ----------------------------------------------

@pytest.mark.parametrize("aucs,verdict", [
    ([0.7508 + d for d in (-0.009, 0.008, -0.004, 0.006, 0.0, -0.002, 0.003,
                           -0.006, 0.004, 0.001)], "closed"),
    ([0.7448 + d for d in (-0.001, 0.001) * 5], "open"),
    ([0.7568 + d for d in (-0.02, 0.02) * 5], "open")])
def test_ce_mean_verdict(aucs, verdict):
    """Closed when the t-test does not reject and the mean is within .005;
    a tight sample .006 away rejects; a loose one .006 away does not reject
    but lies beyond .005."""
    out = roc_3way.ce_mean_verdict(aucs, 0.7508)
    assert out["verdict"].startswith(verdict)
    assert out["n"] == 10 and out["mean"] == pytest.approx(np.mean(aucs))
    if verdict == "open" and out["p"] >= 0.05:
        assert abs(out["mean_minus_jax"]) > roc_3way.CE_MEAN_ABS


def test_ce_mean_runs_the_default_alone(tmp_path, monkeypatch):
    """--ce-mean N runs the CE's stage N times under the process's own
    cuDNN flags, writes its own file with the verdict against the JAX
    file's CE AUC (.750790), and leaves ce_spread.json alone."""
    import torch
    cudnn = torch.backends.cudnn
    seen = []
    monkeypatch.setattr(roc_3way, "ce_auc", lambda root, device: seen.append(
        cudnn.deterministic) or 0.75 + 0.001 * (len(seen) % 3))
    os.makedirs(tmp_path / "configs")
    shutil.copy(ROOT / "configs" / f"args{roc_3way.CE_CONFIG}.json",
                tmp_path / "configs")
    res = roc_3way.main(["--ce-mean", "4", "--root", str(tmp_path),
                         "--device", "cpu"])
    assert seen == [cudnn.deterministic] * 4
    assert list(res) == ["default", "vs_jax"]
    assert res["vs_jax"]["jax_auc"] == pytest.approx(0.750790, abs=1e-6)
    assert res["vs_jax"]["n"] == 4
    assert load_results(str(tmp_path), ROC_3WAY_CE_MEAN) == json.loads(json.dumps(res))
    assert not os.path.exists(tmp_path / ROC_3WAY_CE_SPREAD)
