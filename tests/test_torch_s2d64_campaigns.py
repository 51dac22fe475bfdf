"""The port's s2d64 campaigns (`anoddpm_torch.campaigns.diffuse_calibration`,
`train_longer`, `dense_sweep`, `f3_s2d64`) on the CPU at 32^2.

- Tables: each module's protocols, metrics, tokens, key formats and CLI
  defaults against the JAX script's (`scripts/diffuse_calibration.py`,
  `scripts/train_longer.py`, `scripts/dense_sweep_campaign.py`, loaded
  with importlib).
- Control flow: the JAX script's `main` and the port's `run` on the same
  model tree, with training, model loading and detection replaced by
  recorders on both sides: the same train calls (resume mode, seed,
  substeps, epochs, token), the same copy, the same result keys, in every
  case of the gates.
- Diffuse calibration against JAX: one JAX checkpoint, a per-sample noise
  bank injected into both detect modules (the method of
  `tests/test_torch_sweeps.py`); the per-severity metrics within 1e-4.
- Real runs: the extension trains from params-final and ends at the
  target epoch count, the dense sweep trains and sweeps; a rerun of either
  trains and scores nothing.
- The JAX package's committed evidence of these campaigns is unchanged."""
import hashlib
import importlib.util
import json
import os
import pathlib
import sys
from unittest import mock

import numpy as np
import pytest

from anoddpm_torch import detect as tdetect
from anoddpm_torch.campaigns import (_stages, band, dense_sweep,
                                     diffuse_calibration, f3_s2d64,
                                     seed_replication, train_longer)
from anoddpm_torch.campaigns._results import (DENSE_SWEEP, DIFFUSE_CALIBRATION,
                                              F3_S2D64, TRAIN_LONGER,
                                              load_results, save_results)

ROOT = pathlib.Path(__file__).resolve().parent.parent
# the SMOKE config of tests/test_torch_train.py, 2 anomalous volumes
SMOKE = {"img_size": [32, 32], "Batch_Size": 2,
         "EPOCHS": 1, "T": 10, "base_channels": 32, "channel_mults": [1, 2],
         "attention_resolutions": "16", "beta_schedule": "cosine",
         "loss-type": "l2", "lr": 1e-4, "sample_distance": 8,
         "train_start": True, "noise_fn": "simplex", "dataset": "synthetic",
         "iters_per_epoch": 1, "checkpoint_every": 1, "save_imgs": False,
         "save_vids": False, "seed": 0, "compute_dtype": "float32",
         "anomalous_volumes": 2}
FAKE_SUMMARY = {"auc": 0.75, "dice": 0.2, "ssim": 0.6, "iou": 0.1,
                "precision": 0.3, "recall": 0.2, "fpr": 0.01}


def load_script(name):
    """scripts/{name}.py as a module (it loads anoddpm_tpu only inside
    main); the environment it sets at import is undone."""
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    with mock.patch.dict(os.environ):
        spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_scripts():
    return {n: load_script(n) for n in ("diffuse_calibration", "train_longer",
                                        "dense_sweep_campaign")}


def write_config(root, **over):
    os.makedirs(os.path.join(root, "configs"), exist_ok=True)
    with open(os.path.join(root, "configs", "args256syn64s2d.json"), "w") as f:
        json.dump({**SMOKE, **over}, f)


def model_dir(root, token):
    return os.path.join(root, "model", f"diff-params-ARGS={token}")


def write_final(root, token, n_epoch, payload=b"weights"):
    path = os.path.join(model_dir(root, token), "params-final")
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump({"n_epoch": n_epoch}, f)
    with open(os.path.join(path, "payload.msgpack"), "wb") as f:
        f.write(payload)


def refuse(*a, **k):
    raise AssertionError("a skipped stage ran")


def run_jax_main(monkeypatch, root, script, argv):
    """`script.main()` with cwd `root` (holding the results/ directory that
    a checkout has) and sys.argv `argv`."""
    os.makedirs(os.path.join(root, "results"), exist_ok=True)
    monkeypatch.chdir(root)
    monkeypatch.setattr(sys, "argv", ["script"] + list(argv))
    with mock.patch.dict(os.environ):
        script.main()


def test_tables_equal_the_jax_scripts(jax_scripts):
    dc, tl, ds = (jax_scripts[n] for n in ("diffuse_calibration",
                                           "train_longer",
                                           "dense_sweep_campaign"))
    assert diffuse_calibration.TOKEN == dc.TOKEN == "256syn64s2d_s1"
    assert diffuse_calibration.METRICS == dc.METRICS
    assert diffuse_calibration.key(1.5) == "ddim15_eta1_diffuse_sev1.5"
    assert diffuse_calibration.key(2.0) == "ddim15_eta1_diffuse_sev2"
    assert train_longer.PROTOCOLS == tl.PROTOCOLS
    assert train_longer.METRICS == tl.METRICS
    assert train_longer.target_token(1) == "256syn64s2dL1800_s1"
    assert train_longer.result_key("ddpm200", 1) == "s2dL1800_ddpm200/seed1"
    assert dense_sweep.TOKEN == ds.TOKEN
    for path, jax_name in ((DIFFUSE_CALIBRATION, dc.RESULTS),
                           (TRAIN_LONGER, tl.RESULTS),
                           (DENSE_SWEEP, ds.RESULTS)):
        assert path == jax_name.replace("results/", "results/torch_")
    # the CLI defaults
    assert diffuse_calibration.SEVERITIES == (1.0, 1.5, 2.0, 2.5)
    assert (train_longer.EPOCHS, train_longer.SUBSTEPS) == (1800, 8)
    assert (dense_sweep.STEP, dense_sweep.VOLUMES) == (25, 22)
    assert set(f3_s2d64.CELLS) <= set(seed_replication.PROTOCOLS)
    assert set(f3_s2d64.CELLS) <= set(seed_replication.MODELS["256syn64s2d"])


@pytest.mark.parametrize("argv,want", [
    ([], ([1.0, 1.5, 2.0, 2.5], ".", "256syn64s2d_s1")),
    (["2.5", "3", "--root", "r", "--token", "t"], ([2.5, 3.0], "r", "t"))])
def test_diffuse_calibration_cli(monkeypatch, argv, want):
    seen = []
    monkeypatch.setattr(diffuse_calibration, "run",
                        lambda *a: seen.append(a[:3]))
    diffuse_calibration.main(argv, device="cpu")
    assert [(list(s), r, t) for s, r, t in seen] == [want]


@pytest.mark.parametrize("argv,want", [
    (["1"], (1, 1800, ".")), (["3", "900", "--root", "r"], (3, 900, "r"))])
def test_train_longer_cli(monkeypatch, argv, want):
    seen = []
    monkeypatch.setattr(train_longer, "run", lambda *a: seen.append(a[:3]))
    train_longer.main(argv, device="cpu")
    assert seen == [want]


@pytest.mark.parametrize("argv,want", [
    ([], (25, 22, ".")), (["5", "1", "--root", "r"], (5, 1, "r"))])
def test_dense_sweep_cli(monkeypatch, argv, want):
    seen = []
    monkeypatch.setattr(dense_sweep, "run", lambda *a, **k: seen.append(a[:3]))
    dense_sweep.main(argv, device="cpu")
    assert seen == [want]


def record_train_longer_jax(monkeypatch, seen):
    import anoddpm_tpu.detect as jdetect
    import anoddpm_tpu.train as jtrain
    monkeypatch.setattr(jtrain, "train", lambda args, resume=None: seen.append(
        ("train", args["seed"], args["train_substeps"], args["EPOCHS"],
         args["arg_num"], resume)))
    monkeypatch.setattr(jdetect, "_load_eval_model",
                        lambda root, token: ({"token": token}, None, None))
    monkeypatch.setattr(jdetect, "anomalous_metric_calculation",
                        lambda args, em, sched: seen.append(
                            ("eval", dict(args))) or dict(FAKE_SUMMARY))


def record_train_longer_port(monkeypatch, seen):
    monkeypatch.setattr(train_longer, "train",
                        lambda args, root_dir, resume, device: seen.append(
                            ("train", args["seed"], args["train_substeps"],
                             args["EPOCHS"], args["arg_num"], resume)))
    record_scores(monkeypatch, lambda args: seen.append(("eval", args)))
    monkeypatch.setattr(seed_replication, "train", refuse)


def record_scores(monkeypatch, record):
    """Model loading and detection replaced: `record` gets each protocol's
    arguments (the token under "token"), FAKE_SUMMARY comes back."""
    monkeypatch.setattr(_stages, "_load_eval_model",
                        lambda root, token, device: ({"token": token}, None,
                                                     None))
    monkeypatch.setattr(_stages, "anomalous_metric_calculation",
                        lambda args, **k: record(dict(args))
                        or dict(FAKE_SUMMARY))


@pytest.mark.parametrize("case", ["fresh", "copied", "checkpoint", "trained",
                                  "trained_and_scored"])
def test_train_longer_control_flow_equals_jax(jax_scripts, monkeypatch,
                                              tmp_path, case):
    """The JAX script and the port on the same tree: "fresh" (only the
    600-epoch source: copy, RESUME_FINAL), "copied" (the target holds the
    copied params-final: no copy, RESUME_FINAL), "checkpoint" (and a
    periodic checkpoint: RESUME_RECENT), "trained" (the target records the
    epochs: no training), "trained_and_scored" (and every result: nothing
    at all)."""
    target = "256syn64s2dL700_s1"
    records = {}
    for side in ("jax", "port"):
        root = str(tmp_path / side)
        write_config(root)
        write_final(root, "256syn64s2d_s1", 600, payload=b"source")
        if case != "fresh":
            write_final(root, target, 700 if case.startswith("trained") else 600,
                        payload=b"target")
        if case == "checkpoint":
            os.makedirs(os.path.join(model_dir(root, target), "checkpoint",
                                     "diff_epoch=900"))
        if case == "trained_and_scored":
            save_results(root, TRAIN_LONGER if side == "port"
                         else "results/train_longer.json",
                         {train_longer.result_key(c, 1, 700): {"auc": 0.5}
                          for c in train_longer.PROTOCOLS})
        seen = []
        if side == "jax":
            record_train_longer_jax(monkeypatch, seen)
            run_jax_main(monkeypatch, root, jax_scripts["train_longer"],
                         ["1", "700"])
            name = "results/train_longer.json"
        else:
            record_train_longer_port(monkeypatch, seen)
            train_longer.main(["1", "700", "--root", root], device="cpu")
            name = TRAIN_LONGER
        with open(os.path.join(model_dir(root, target), "params-final",
                               "payload.msgpack"), "rb") as f:
            payload = f.read()
        records[side] = (seen, payload, load_results(root, name))
    assert records["port"] == records["jax"]
    seen, payload, res = records["port"]
    trains = [s for s in seen if s[0] == "train"]
    evals = [s for s in seen if s[0] == "eval"]
    want_resume = {"fresh": "RESUME_FINAL", "copied": "RESUME_FINAL",
                   "checkpoint": "RESUME_RECENT"}.get(case)
    assert trains == ([("train", 1, 8, 700, target, want_resume)]
                      if want_resume else [])
    assert payload == (b"source" if case == "fresh" else b"target")
    assert len(evals) == (0 if case == "trained_and_scored" else 3)
    assert sorted(res) == sorted(train_longer.result_key(c, 1, 700)
                                 for c in train_longer.PROTOCOLS)


def test_train_longer_extends_then_skips(tmp_path, monkeypatch):
    """Seed 1 trained for 1 epoch by `ensure_trained` (the source is absent),
    then extended to 2 from the copied params-final: the target records 2
    epochs, the source still 1; every protocol scored; a rerun trains and
    scores nothing."""
    root = str(tmp_path)
    write_config(root)
    res = train_longer.run(1, 2, root, device="cpu")
    assert sorted(res) == sorted(train_longer.result_key(c, 1, 2)
                                 for c in train_longer.PROTOCOLS)
    assert all(np.isfinite(v) for e in res.values() for v in e.values())
    assert _stages.train_gate(root, "256syn64s2dL2_s1", 2) == (2, False, None)
    assert _stages.train_gate(root, "256syn64s2d_s1", 2)[0] == 1
    assert load_results(root, TRAIN_LONGER) == res
    for mod, name in ((train_longer, "train"), (_stages, "_load_eval_model"),
                      (seed_replication, "train")):
        monkeypatch.setattr(mod, name, refuse)
    assert train_longer.run(1, 2, root, device="cpu") == res


def record_dense_jax(monkeypatch, seen):
    import anoddpm_tpu.detect as jdetect
    import anoddpm_tpu.train as jtrain
    monkeypatch.setattr(jtrain, "train", lambda args, resume=None: seen.append(
        ("train", args["EPOCHS"], args["skip_test_eval"], args["arg_num"],
         resume)))
    monkeypatch.setattr(jdetect, "graph_data", lambda **k: seen.append(
        ("graph", k["token"], k["dense"], k["lambda_step"], k["max_volumes"]))
        or write_volume_csvs("."))


def record_dense_port(monkeypatch, seen, root):
    monkeypatch.setattr(dense_sweep, "train",
                        lambda args, root_dir, resume, device: seen.append(
                            ("train", args["EPOCHS"], args["skip_test_eval"],
                             args["arg_num"], resume)))
    monkeypatch.setattr(dense_sweep, "graph_data", lambda **k: seen.append(
        ("graph", k["token"], k["dense"], k["lambda_step"], k["max_volumes"]))
        or write_volume_csvs(k["root_dir"]))


def write_volume_csvs(root):
    d = os.path.join(root, "metrics", "ARGS=256syn64s2d")
    os.makedirs(d, exist_ok=True)
    for name in ("vol-b.csv", "vol-a.csv", "vol-a.png"):
        open(os.path.join(d, name), "w").close()


@pytest.mark.parametrize("case", ["fresh", "checkpoint", "trained",
                                  "retrained"])
def test_dense_sweep_equals_jax(jax_scripts, monkeypatch, tmp_path, case):
    """The train gate (fresh, RESUME_RECENT from a periodic checkpoint, or
    no training once params-final records the config's epochs), the
    graph_data call (dense, the step and volume count), the result keys and
    the sorted CSV names: the same on both sides, walls apart.  "retrained":
    the results record a sweep at this grid but the model is gone, so it is
    trained and swept again."""
    records = {}
    for side in ("jax", "port"):
        root = str(tmp_path / side)
        write_config(root, EPOCHS=3)
        if case == "trained":
            write_final(root, "256syn64s2d", 3)
        if case == "checkpoint":
            os.makedirs(os.path.join(model_dir(root, "256syn64s2d"),
                                     "checkpoint", "diff_epoch=1"))
        if case == "retrained":
            save_results(root, DENSE_SWEEP if side == "port"
                         else "results/dense_sweep_full.json",
                         {"lambda_step": 5, "volumes": 2, "sweep_seconds": 1.0,
                          "csv_files": ["old.csv"]})
        seen = []
        if side == "jax":
            record_dense_jax(monkeypatch, seen)
            run_jax_main(monkeypatch, root, jax_scripts["dense_sweep_campaign"],
                         ["5", "2"])
            with open(os.path.join(root, "results/dense_sweep_full.json")) as f:
                res = json.load(f)
        else:
            record_dense_port(monkeypatch, seen, root)
            res = dense_sweep.main(["5", "2", "--root", root], device="cpu")
            assert load_results(root, DENSE_SWEEP) == res
        records[side] = (seen, {k: v for k, v in res.items()
                                if not k.endswith("_seconds")}, sorted(res))
    assert records["port"] == records["jax"]
    seen, res, keys = records["port"]
    want_train = {"fresh": [("train", 3, True, "256syn64s2d", None)],
                  "checkpoint": [("train", 3, True, "256syn64s2d",
                                  "RESUME_RECENT")],
                  "trained": [],
                  "retrained": [("train", 3, True, "256syn64s2d", None)]}[case]
    assert seen == want_train + [("graph", "256syn64s2d", True, 5, 2)]
    assert res["csv_files"] == ["vol-a.csv", "vol-b.csv"]
    assert (res["lambda_step"], res["volumes"]) == (5, 2)
    assert ("train_seconds" in keys) == (case != "trained")


def test_dense_sweep_extends_a_short_model(tmp_path, monkeypatch):
    """A params-final that records fewer epochs than the config is trained
    on from itself (RESUME_FINAL), then swept; the JAX script's gate, on
    the file's presence alone, would sweep the short model."""
    root = str(tmp_path)
    write_config(root, EPOCHS=3)
    write_final(root, "256syn64s2d", 2)
    seen = []
    record_dense_port(monkeypatch, seen, root)
    res = dense_sweep.run(5, 2, root, device="cpu")
    assert seen == [("train", 3, True, "256syn64s2d", "RESUME_FINAL"),
                    ("graph", "256syn64s2d", True, 5, 2)]
    assert res["train_epochs"] == 3


def test_dense_sweep_trains_sweeps_then_skips(tmp_path, monkeypatch):
    """At 32^2 (T 10): the model trained (1 epoch), every 3rd lambda on 1
    volume; the pooled CSV's lambda = 0 row leaves the slice as it is
    (SSIM 1, AUC 0.5, Dice ~0); a rerun at the same grid trains and sweeps
    nothing."""
    root = str(tmp_path)
    write_config(root)
    res = dense_sweep.run(3, 1, root, device="cpu")
    assert sorted(res) == ["csv_files", "lambda_step", "sweep_seconds",
                           "train_epochs", "train_seconds", "volumes"]
    assert res["train_epochs"] == 1 and res["csv_files"] == [
        "synthetic-anomalous-00000.csv"]
    with open(os.path.join(root, "metrics", "args256syn64s2d-lambda.csv")) as f:
        rows = [r.split(",") for r in f.read().split()]
    assert rows[0] == ["t", "dice", "ssim", "iou", "auc"]
    assert [int(r[0]) for r in rows[1:]] == [0, 3, 6, 9]
    assert float(rows[1][2]) == pytest.approx(1.0, abs=1e-6)
    assert float(rows[1][4]) == 0.5 and float(rows[1][1]) < 1e-3
    monkeypatch.setattr(dense_sweep, "train", refuse)
    monkeypatch.setattr(dense_sweep, "graph_data", refuse)
    assert dense_sweep.run(3, 1, root, device="cpu") == res


def test_dense_sweep_replot_from_the_csvs(tmp_path):
    """--replot on a copy of the JAX package's 22 per-volume CSVs and pooled
    CSV: one PNG per volume beside its CSV and the pooled plot, without a
    card."""
    import shutil
    vol_dir = tmp_path / "ARGS=256syn64s2d"
    vol_dir.mkdir()
    for f in (ROOT / "metrics" / "ARGS=256syn64s2d").glob("*.csv"):
        shutil.copy(f, vol_dir)
    shutil.copy(ROOT / "metrics" / "args256syn64s2d-lambda.csv", tmp_path)
    written = dense_sweep.main(["--replot", str(tmp_path)])
    assert len(written) == 23
    assert sorted(p.name for p in vol_dir.glob("*.png")) == sorted(
        p.name[:-4] + ".png" for p in vol_dir.glob("*.csv"))
    assert (tmp_path / "args256syn64s2d-dice-lambda.png").exists()
    for path in written:
        with open(path, "rb") as f:
            assert f.read(8) == b"\x89PNG\r\n\x1a\n"


def test_f3_scores_the_cells_against_the_band(tmp_path, monkeypatch):
    """Each cell under its seed-replication protocol, held against that
    cell's JAX band; a rerun scores nothing."""
    root = str(tmp_path)
    seen = []
    record_scores(monkeypatch, seen.append)
    res = f3_s2d64.main(["--root", root], device="cpu")
    assert sorted(res) == sorted(f"{c}/seed0" for c in f3_s2d64.CELLS)
    for cell, args in zip(f3_s2d64.CELLS, seen):
        assert args == {"token": "256syn64s2d",
                        **seed_replication.PROTOCOLS[cell]}
        entry = res[f"{cell}/seed0"]
        assert entry["band"] == band.hold(FAKE_SUMMARY, cell=cell)
        assert {m: entry[m] for m in seed_replication.METRICS} == {
            m: FAKE_SUMMARY[m] for m in seed_replication.METRICS}
    assert load_results(root, F3_S2D64) == res
    monkeypatch.setattr(_stages, "_load_eval_model", refuse)
    assert f3_s2d64.run(root, device="cpu") == res


# the per-sample noise bank and checkpoint of tests/test_torch_sweeps.py
SWEEP_ARGS = {"img_size": [32, 32], "T": 20, "beta_schedule": "cosine",
              "base_channels": 32, "channel_mults": "1 2",
              "attention_resolutions": "16", "noise_fn": "simplex",
              "dataset": "synthetic", "compute_dtype": "float32",
              "anomalous_volumes": 1, "Batch_Size": 2, "sample_distance": 8}


def test_diffuse_calibration_matches_jax(jax_scripts, monkeypatch, tmp_path):
    """The JAX script and the port on one JAX checkpoint (the tiny UNet,
    perturbed weights, T 20) with one per-sample noise bank injected into
    both detect modules: at severities 1 and 2.5, DDIM-15 at eta = 1 on the
    diffuse family (lambda clamped to T), AUC, Dice, SSIM and IoU within
    1e-4 of each other, under the same keys."""
    import optax
    from anoddpm_tpu import checkpoint as jckpt
    from anoddpm_tpu import detect as jdetect
    from anoddpm_tpu.config import defaultdict_from_json
    from torch_parity import CONFIGS, flax_and_port, per_sample_bank_samplers
    _, params, _ = flax_and_port(CONFIGS["s2d1"], seed=3)
    jsamp, tsamp = per_sample_bank_samplers((4, 32, 32, 1), steps=20)
    monkeypatch.setattr(jdetect, "sampler_from_args", lambda a: jsamp)
    monkeypatch.setattr(tdetect, "sampler_from_args", lambda a: tsamp)
    out = {}
    for side in ("jax", "port"):
        root = tmp_path / side
        root.mkdir()
        args = defaultdict_from_json({**SWEEP_ARGS, "arg_num": "dc"})
        jckpt.save_checkpoint(str(root), args, 0, params, params,
                              optax.adamw(1e-4).init(params), final=True)
        if side == "jax":
            monkeypatch.setattr(jax_scripts["diffuse_calibration"], "TOKEN", "dc")
            run_jax_main(monkeypatch, str(root),
                         jax_scripts["diffuse_calibration"], ["1", "2.5"])
            with open(root / "results" / "diffuse_calibration.json") as f:
                out[side] = json.load(f)
        else:
            out[side] = diffuse_calibration.main(
                ["1", "2.5", "--root", str(root), "--token", "dc"], device="cpu")
    assert sorted(out["port"]) == sorted(out["jax"]) == [
        "ddim15_eta1_diffuse_sev1", "ddim15_eta1_diffuse_sev2.5"]
    for key, want in out["jax"].items():
        got = out["port"][key]
        assert sorted(got) == sorted(want)
        for m in want:
            assert abs(got[m] - want[m]) <= 1e-4, (key, m, got[m], want[m])
    monkeypatch.setattr(_stages, "_load_eval_model", refuse)
    assert diffuse_calibration.run([1.0, 2.5], str(tmp_path / "port"), "dc",
                                   device="cpu") == out["port"]


# sha256 of the JAX package's committed results of these campaigns: the
# port writes its own files (results/torch_*) and never these
JAX_EVIDENCE = {
    "results/dense_sweep_full.json":
        "b0faf6f018597c1df82da08fd4897a82a240385e13991bb0329cdf0d322eb1b7",
    "results/diffuse_calibration.json":
        "e3c64d7d5616ca406c086b1185c7e3db532bef018e44c1bb79025ae5b327b491",
    "metrics/args256syn64s2d-lambda.csv":
        "b8f9291f32ace019fe742122aba661b1d6844b9d7d1b21a591d98920925d406c",
    # the 22 per-volume CSVs and plots, by name and content
    "metrics/ARGS=256syn64s2d":
        "21d6b1c0bc467367d39aa66f3a1daaa63672fe7e1c58e8a3c6ae145d54aaa627",
    # round 1's model-size and s2d quality files (75887cc)
    "results/model_size_quality.json":
        "545a3c3230be4256c8eb3b84cb46ccf49930c6c1b17eb2a0a3efa8f96d463336",
    "results/s2d_quality.json":
        "a7707e2a7fbf74f32ad9ba4c12126f90e16ce13ea9d8aa3cc9c9fe20e740157c",
}


def digest(path):
    h = hashlib.sha256()
    paths = sorted(path.iterdir()) if path.is_dir() else [path]
    for p in paths:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()


@pytest.mark.parametrize("rel", sorted(JAX_EVIDENCE))
def test_jax_evidence_is_unchanged(rel):
    assert digest(ROOT / rel) == JAX_EVIDENCE[rel]
