"""The port's quality campaigns (`anoddpm_torch.campaigns`) on the CPU at
32^2: the flagship campaign end to end with the JAX script's result keys
and its skips, the train gate's three resume cases, the seed-replication
campaign and its `aggregate` against the JAX script's (and against the
aggregates committed in results/seed_replication.json), the two small
campaigns, and the band."""
import copy
import importlib.util
import json
import os
import pathlib
from unittest import mock

import numpy as np
import pytest

from anoddpm_torch.campaigns import (band, dense_sweep, diffuse_calibration,
                                     f3_s2d64, flagship, model_size_quality,
                                     quality_compare, seed_replication,
                                     train_longer)
from anoddpm_torch.campaigns._results import (FLAGSHIP, SEED_REPLICATION,
                                              load_results, save_results)

ROOT = pathlib.Path(__file__).resolve().parent.parent
JAX_SEED_RESULTS = ROOT / "results" / "seed_replication.json"
# the SMOKE config of tests/test_torch_train.py, 2 anomalous volumes
SMOKE = {"img_size": [32, 32], "Batch_Size": 2,
         "EPOCHS": 2, "T": 10, "base_channels": 32, "channel_mults": [1, 2],
         "attention_resolutions": "16", "beta_schedule": "cosine",
         "loss-type": "l2", "lr": 1e-4, "sample_distance": 8,
         "train_start": True, "noise_fn": "simplex", "dataset": "synthetic",
         "iters_per_epoch": 1, "checkpoint_every": 1, "save_imgs": False,
         "save_vids": False, "seed": 0, "compute_dtype": "float32",
         "anomalous_volumes": 2}
# the keys scripts/flagship_campaign.py writes at an epoch target E
# (:103-106 train, :117-119 the protocols, :139 testing, :150 figures)
JAX_KEYS = {"train_seconds@{E}", "train_slice@{E}", "train_epochs",
            "flagship_ddpm200@{E}", "flagship_ddim15_eta1@{E}", "testing@{E}",
            "figures_done"}
TESTING_KEYS = {"total_vlb", "total_vlb_std", "prior_vlb", "prior_vlb_std",
                "vb_at_200", "x_0_mse_at_200", "mse_at_200", "psnr",
                "psnr_std"}


def write_config(root, token="tsmoke", **over):
    os.makedirs(os.path.join(root, "configs"), exist_ok=True)
    with open(os.path.join(root, "configs", f"args{token}.json"), "w") as f:
        json.dump({**SMOKE, **over}, f)


def write_final(root, token, n_epoch):
    path = os.path.join(root, "model", f"diff-params-ARGS={token}",
                        "params-final")
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump({"n_epoch": n_epoch}, f)


def refuse(*a, **k):
    raise AssertionError("a skipped stage ran")


def test_flagship_end_to_end_then_every_stage_skipped(tmp_path, monkeypatch):
    root = str(tmp_path)
    write_config(root)
    res = flagship.main(["--root", root, "--token", "tsmoke"], device="cpu")
    assert set(res) == {k.format(E=2) for k in JAX_KEYS}
    assert res["train_slice@2"] == [0, 2] and res["train_epochs"] == 2
    for cell in flagship.PROTOCOLS:
        entry = res[f"flagship_{cell}@2"]
        assert set(entry) == set(flagship.METRICS) | {"eval_seconds"}
        assert all(np.isfinite(v) for v in entry.values())
    assert set(res["testing@2"]) == TESTING_KEYS | {"eval_seconds"}
    assert res["figures_done"] is True
    assert load_results(root, FLAGSHIP) == res
    for name in ("metrics/argstsmoke.csv", "metrics/argstsmoke-test.json",
                 "final-outputs/ARGS=tsmoke-masked-comparison.png",
                 "final-outputs/ARGS=tsmoke/attempt=1-0.5-predictions.png"):
        assert os.path.exists(os.path.join(root, name)), name
    # the rerun skips every stage
    for name in ("train", "anomalous_metric_calculation", "testing",
                 "_load_eval_model"):
        monkeypatch.setattr(flagship, name, refuse)
    assert flagship.main(["--root", root, "--token", "tsmoke"],
                         device="cpu") == res


@pytest.mark.parametrize("case,want", [
    ("fresh", (0, True, None)),
    ("checkpoint", (0, True, "RESUME_RECENT")),
    ("final_short", (1, True, "RESUME_FINAL")),
    ("final_short_and_checkpoint", (1, True, "RESUME_RECENT")),
    ("final_done", (2, False, None)),
])
def test_train_gate(tmp_path, monkeypatch, case, want):
    """The gate of scripts/flagship_campaign.py:84-99, and the resume mode
    that reaches `train`."""
    root = str(tmp_path)
    write_config(root)
    base = os.path.join(root, "model", "diff-params-ARGS=tsmoke")
    if "checkpoint" in case:
        os.makedirs(os.path.join(base, "checkpoint", "diff_epoch=1"))
    if case.startswith("final"):
        write_final(root, "tsmoke", 2 if case == "final_done" else 1)
    assert flagship.train_gate(root, "tsmoke", 2) == want
    seen = []
    monkeypatch.setattr(flagship, "train",
                        lambda args, **k: seen.append((args["EPOCHS"], k)))
    res = flagship.run(root, "tsmoke", protocols=[], skip_testing=True,
                       skip_figures=True, device="cpu")
    if want[1]:
        [(epochs, kwargs)] = seen
        assert epochs == 2 and kwargs["resume"] == want[2]
        assert res["train_slice@2"] == [want[0], 2]
    else:
        assert seen == [] and res == {}


def test_cli_reaches_train_and_the_protocol(tmp_path, monkeypatch):
    """The epoch target, substeps and skip_test_eval reach `train`; the
    chosen protocol's sampler reaches the detection call."""
    root = str(tmp_path)
    write_config(root)
    seen = []
    monkeypatch.setattr(flagship, "train", lambda args, **k: seen.append(args))
    monkeypatch.setattr(flagship, "_load_eval_model",
                        lambda *a, **k: ({"sampler": ""}, None, None))
    monkeypatch.setattr(flagship, "anomalous_metric_calculation",
                        lambda args, **k: seen.append(args) or dict.fromkeys(
                            flagship.METRICS, 0.5))
    res = flagship.main(["3", "--root", root, "--token", "tsmoke",
                         "--substeps", "2", "--protocols=ddpm200",
                         "--skip-testing", "--skip-figures"], device="cpu")
    [args, eval_args] = seen
    assert (args["EPOCHS"], args["train_substeps"], args["skip_test_eval"]) \
        == (3, 2, True)
    assert eval_args == {"sampler": "ddpm"}
    assert set(res) == {"train_seconds@3", "train_slice@3", "train_epochs",
                        "flagship_ddpm200@3"}


def test_legacy_key_at_600_is_skipped(tmp_path, monkeypatch):
    """A result from before the epoch-keyed names ("flagship_{cell}") stands
    for the 600-epoch target, and only for it."""
    root = str(tmp_path)
    write_config(root, EPOCHS=600)
    write_final(root, "tsmoke", 600)
    legacy = {"flagship_ddpm200": {"auc": 0.5}, "flagship_ddim15_eta1": {}}
    save_results(root, FLAGSHIP, legacy)
    for name in ("train", "anomalous_metric_calculation", "_load_eval_model"):
        monkeypatch.setattr(flagship, name, refuse)
    assert flagship.run(root, "tsmoke", skip_testing=True, skip_figures=True,
                        device="cpu") == legacy
    write_final(root, "tsmoke", 601)
    with pytest.raises(AssertionError, match="skipped stage"):
        flagship.run(root, "tsmoke", epochs=601, skip_testing=True,
                     skip_figures=True, device="cpu")


def test_cli_options():
    got = flagship.parse_argv(["700", "--protocols=ddim15_eta1",
                               "--skip-testing", "--root", "r", "--token",
                               "t", "--substeps", "8"])
    assert got == {"root_dir": "r", "token": "t", "epochs": 700,
                   "protocols": ["ddim15_eta1"], "skip_testing": True,
                   "skip_figures": False, "substeps": 8}
    assert flagship.parse_argv([])["token"] == "256syn128"
    with pytest.raises(SystemExit, match="unknown protocol"):
        flagship.parse_argv(["--protocols=ddpm200,ddim99"])


def test_entry_points_refuse_without_cuda(monkeypatch, tmp_path):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for run in (lambda: flagship.main(["--root", str(tmp_path)]),
                lambda: seed_replication.main(["--root", str(tmp_path)]),
                lambda: quality_compare.main(["1", "--root", str(tmp_path)]),
                lambda: model_size_quality.main(["1", "--root", str(tmp_path)]),
                lambda: diffuse_calibration.main(["--root", str(tmp_path)]),
                lambda: train_longer.main(["1", "--root", str(tmp_path)]),
                lambda: dense_sweep.main(["--root", str(tmp_path)]),
                lambda: f3_s2d64.main(["--root", str(tmp_path)])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            run()


@pytest.fixture(scope="module")
def jax_script():
    """scripts/seed_replication.py as a module (it loads anoddpm_tpu only
    inside its functions); the environment it sets at import is undone."""
    spec = importlib.util.spec_from_file_location(
        "jax_seed_replication", ROOT / "scripts" / "seed_replication.py")
    mod = importlib.util.module_from_spec(spec)
    with mock.patch.dict(os.environ):
        spec.loader.exec_module(mod)
    return mod


def test_tables_equal_the_jax_script(jax_script):
    assert seed_replication.MODELS == jax_script.MODELS
    assert seed_replication.PROTOCOLS == jax_script.PROTOCOLS
    assert seed_replication.METRICS == jax_script.METRICS


def test_aggregate_equals_the_jax_script(jax_script):
    """Five seeds, then a one-seed catch-up (seed 5 of one cell only):
    both aggregates run over every seed in the results, and agree."""
    rng = np.random.default_rng(0)
    res = {}
    for cell in ("paper128_ddpm200", "s2d64_ddim15_eta1", "s2d64_ddpm200"):
        for s in range(5):
            res[f"{cell}/seed{s}"] = {m: float(rng.uniform(0, 1))
                                      for m in seed_replication.METRICS}
    res["s2d64_ddim15_eta1/seed_note"] = {"auc": 9.0}   # not a seed entry
    ours, theirs = copy.deepcopy(res), copy.deepcopy(res)
    seed_replication.aggregate(ours, [0, 1, 2, 3, 4])
    jax_script.aggregate(theirs, [0, 1, 2, 3, 4])
    assert ours == theirs
    assert ours["paper128_ddpm200/aggregate"]["auc"]["n"] == 5
    catch_up = {m: float(rng.uniform(0, 1)) for m in seed_replication.METRICS}
    for r in (ours, theirs):
        r["paper128_ddpm200/seed5"] = dict(catch_up)
    seed_replication.aggregate(ours, [5])
    jax_script.aggregate(theirs, [5])
    assert ours == theirs
    agg = ours["paper128_ddpm200/aggregate"]["auc"]
    vals = [ours[f"paper128_ddpm200/seed{s}"]["auc"] for s in range(6)]
    assert agg["n"] == 6 and agg["std"] == float(np.std(vals))
    assert ours["s2d64_ddpm200/aggregate"]["auc"]["n"] == 5


def test_aggregate_reproduces_the_committed_file():
    """The per-seed entries of results/seed_replication.json give its
    committed aggregates to 1e-12; the bf16-norm cell's aggregate, written
    by scripts/bf16_norm_ab.py with the same rule, is a cell outside
    MODELS."""
    with open(JAX_SEED_RESULTS) as f:
        committed = json.load(f)
    aggregates = {k: v for k, v in committed.items() if k.endswith("/aggregate")}
    res = {k: v for k, v in committed.items() if k not in aggregates}
    with mock.patch.dict(seed_replication.MODELS,
                         bf16norm=["s2d64_ddim25_eta1_bf16norm"]):
        seed_replication.aggregate(res)
    assert set(k for k in res if k.endswith("/aggregate")) == set(aggregates)
    assert len(aggregates) == 10
    for key, agg in aggregates.items():
        for m, a in agg.items():
            assert res[key][m]["n"] == a["n"]
            assert abs(res[key][m]["mean"] - a["mean"]) <= 1e-12
            assert abs(res[key][m]["std"] - a["std"]) <= 1e-12


def test_work_list_cheapest_first_with_skip():
    res = {"s2d64_ddim15_eta1/seed0": {}}
    work = seed_replication.work_list(res, [0, 1], skip=["diffuse", "x2", "x3"])
    assert work[0] == (15, "256syn64s2d", "s2d64_ddim15_eta1", 1)
    assert [w[0] for w in work] == sorted(w[0] for w in work)
    assert not any("diffuse" in w[2] or "x2" in w[2] for w in work)
    assert (200, "256syn128", "paper128_ddpm200", 0) in work
    assert len(work) == 2 * 6 - 1
    args = seed_replication.train_args_for("256syn128", 3, str(ROOT))
    assert (args["seed"], args["train_substeps"], args["arg_num"]) == \
        (3, 8, "256syn128_s3")


@pytest.mark.parametrize("skip, trained", [
    (["paper128"], ["256syn64s2d"]),
    (["s2d64"], ["256syn128"]),
    ([], ["256syn128", "256syn64s2d"]),
    (["paper128", "s2d64"], []),
])
def test_run_trains_only_configs_with_a_cell_left(tmp_path, skip, trained):
    """seed_replication.run with `ensure_trained` and scoring replaced by
    recorders: a config is trained (every seed) only when a cell of it is
    left after `skip`, and exactly the kept cells are scored; with no skip
    every config trains, as before."""
    calls, scored = [], []

    def ensure(config, seed, root_dir, device):
        calls.append((config, seed))
        return f"{config}_s{seed}"

    def load(root_dir, token, device):
        return {"token": token}, None, None

    def metric(args, root_dir, em, sched, device):
        scored.append((args["token"], args.get("ddim_steps", 200)))
        return {m: 0.5 for m in seed_replication.METRICS}

    with mock.patch.object(seed_replication, "ensure_trained", ensure), \
            mock.patch.object(seed_replication, "_load_eval_model", load), \
            mock.patch.object(seed_replication, "anomalous_metric_calculation",
                              metric):
        res = seed_replication.run([2, 3], skip=skip, root_dir=str(tmp_path),
                                   device="cpu")
    assert calls == [(c, s) for c in trained for s in (2, 3)]
    kept = [cell for c in trained
            for cell in seed_replication.kept_cells(c, skip)]
    assert len(scored) == 2 * len(kept)
    assert {t.rsplit("_s", 1)[0] for t, _ in scored} == set(trained)
    assert {k for k in res if "/seed" in k} == {
        f"{cell}/seed{s}" for cell in kept for s in (2, 3)}
    if skip == ["paper128"]:
        assert len(kept) == 9 and not any("paper128" in k for k in res)


def test_seed_replication_and_small_campaigns_on_cpu(tmp_path):
    """seed_replication.run trains tsmoke_s0, scores one cell on it and
    aggregates over every seed in the file (seed 1's entry was there
    before: n = 2); a rerun trains and scores nothing; then quality_compare
    and model_size_quality on tsmoke_s0."""
    root = str(tmp_path)
    write_config(root, EPOCHS=1)
    cell = "s2d64_ddim15_eta1"
    models = mock.patch.dict(seed_replication.MODELS, {"tsmoke": [cell]},
                             clear=True)
    earlier = {m: 0.5 for m in seed_replication.METRICS}
    save_results(root, SEED_REPLICATION, {f"{cell}/seed1": earlier})
    with models:
        res = seed_replication.run([0], root_dir=root, device="cpu")
    assert set(res) == {f"{cell}/seed0", f"{cell}/seed1", f"{cell}/aggregate"}
    agg = res[f"{cell}/aggregate"]["auc"]
    assert agg["n"] == 2
    assert agg["mean"] == float(np.mean([res[f"{cell}/seed0"]["auc"], 0.5]))
    assert load_results(root, SEED_REPLICATION) == res
    with mock.patch.object(seed_replication, "train", refuse), \
            mock.patch.object(seed_replication, "_load_eval_model", refuse), \
            models:
        assert seed_replication.run([0], root_dir=root, device="cpu") == res
    out = quality_compare.run("tsmoke_s0", [5], root_dir=root, device="cpu")
    assert set(out) == {"ddpm_full", "ddim_5"}
    out = model_size_quality.run(["tsmoke_s0"], root_dir=root, device="cpu")
    assert set(out) == {f"tsmoke_s0/{p}" for p, _ in model_size_quality.PROTOCOLS}
    with open(os.path.join(root, model_size_quality.OUT)) as f:
        assert json.load(f) == out


def test_band_holds_the_jax_seeds_and_refuses_a_low_auc():
    with open(JAX_SEED_RESULTS) as f:
        committed = json.load(f)
    b = band.load_band()
    assert b["auc"]["n"] == 5
    agg = committed["paper128_ddpm200/aggregate"]
    for m in ("auc", "dice", "iou", "ssim"):
        assert b[m]["lo"] == agg[m]["mean"] - 2 * agg[m]["std"]
        assert b[m]["hi"] == agg[m]["mean"] + 2 * agg[m]["std"]
    assert (round(b["auc"]["lo"], 4), round(b["auc"]["hi"], 4)) == (0.7075, 0.7771)
    for s in range(5):
        held = band.hold(committed[f"paper128_ddpm200/seed{s}"])
        assert set(held) == {"auc", "dice", "iou", "ssim"}
        assert all(h["inside"] for h in held.values()), (s, held)
    made_up = dict(committed["paper128_ddpm200/seed0"], auc=0.70)
    held = band.hold(made_up)
    assert not held["auc"]["inside"] and held["dice"]["inside"]
    assert "auc 0.7000 OUTSIDE" in band.verdict(made_up)


@pytest.mark.parametrize("port, jax", [
    ([0.2029, 0.1363, 0.1511, 0.1702], [0.1559, 0.1502, 0.1633, 0.1590, 0.1516]),
    ([0.71, 0.74, 0.73, 0.76, 0.70], [0.72, 0.73, 0.745, 0.735, 0.74]),
    ([1.0, 2.0], [1.5, 1.25, 1.75]),
])
def test_compare_matches_scipy(port, jax):
    """band.compare against scipy.stats on fixed vectors: Welch's t and p
    equal `ttest_ind(equal_var=False)`, the F-test's p is twice the smaller
    tail of F(n_port - 1, n_jax - 1) at var(port) / var(JAX), sample std
    with ddof 1; each to 1e-12."""
    from scipy import stats
    got = band.compare(port, jax)
    welch = stats.ttest_ind(port, jax, equal_var=False)
    a, b = np.asarray(port), np.asarray(jax)
    f = a.var(ddof=1) / b.var(ddof=1)
    tail = stats.f.cdf(f, a.size - 1, b.size - 1)
    want_p = 2 * min(tail, 1 - tail)
    assert got["port"] == {"n": a.size, "mean": pytest.approx(a.mean(), abs=1e-12),
                           "std": pytest.approx(a.std(ddof=1), abs=1e-12)}
    assert got["jax"]["n"] == b.size
    assert abs(got["jax"]["std"] - stats.tstd(b)) <= 1e-12
    assert abs(got["welch_t"] - welch.statistic) <= 1e-12
    assert abs(got["welch_p"] - welch.pvalue) <= 1e-12
    assert abs(got["f"] - f) <= 1e-12 and abs(got["f_p"] - want_p) <= 1e-12
    # the F-test is symmetric in its sides: swapping them keeps p
    assert abs(band.compare(jax, port)["f_p"] - got["f_p"]) <= 1e-12


def test_holm_step_down():
    """Holm at 0.05 over 4 p-values: .01 <= .05/4 and .015 <= .05/3
    reject, .03 > .05/2 stops the descent, so .04 does not reject (though
    under .05); the adjusted p-values are the running max of (m - k) p."""
    out = band.holm({"a": 0.04, "b": 0.01, "c": 0.03, "d": 0.015})
    assert [out[k]["rejected"] for k in "abcd"] == [False, True, False, True]
    assert [round(out[k]["adjusted_p"], 12) for k in "bdca"] == [0.04, 0.045,
                                                                 0.06, 0.06]
    assert not any(v["rejected"] for v in band.holm({"x": 0.5}).values())


def test_two_sample_jax_file_split_against_itself(tmp_path):
    """The JAX package's seeds 0-2 as the 'port' against its seeds 3-4,
    through the CLI on files: every s2d64 cell both hold is compared in
    AUC and Dice, and neither Holm family rejects."""
    with open(JAX_SEED_RESULTS) as f:
        committed = json.load(f)
    first = {k: v for k, v in committed.items() if k[-5:] in ("seed0", "seed1", "seed2")}
    last = {k: v for k, v in committed.items() if k[-5:] in ("seed3", "seed4")}
    save_results(str(tmp_path), SEED_REPLICATION, first)
    save_results(str(tmp_path), "jax.json", last)
    out = band.main(["--root", str(tmp_path), "--jax",
                     str(tmp_path / "jax.json")])
    assert load_results(str(tmp_path), band.F3_TWO_SAMPLE) == json.loads(
        json.dumps(out))
    cells = [c for c in seed_replication.MODELS["256syn64s2d"]
             if f"{c}/aggregate" in committed]
    assert list(out["cells"]) == cells and len(cells) == 8
    assert out["cells"][cells[0]]["port_seeds"] == [0, 1, 2]
    assert out["cells"][cells[0]]["jax_seeds"] == [3, 4]
    assert len(out["holm"]["welch"]) == len(out["holm"]["f"]) == 16
    assert out["rejected"] == {"welch": [], "f": []}
    assert out["verdict"] == "training spread"


def test_two_sample_verdicts():
    """A port sample far above the JAX one is a fault in the level; one
    spread 20x wider in one cell is a fault in the spread, named by that
    cell; one seed a side compares nothing."""
    jax = {f"c/seed{s}": {"auc": 0.70 + 0.01 * s, "dice": 0.15 + 0.002 * s}
           for s in range(5)}
    high = {f"c/seed{s}": {"auc": 0.90 + 0.01 * s, "dice": 0.25 + 0.002 * s}
            for s in range(5)}
    out = band.two_sample(high, jax, ["c"])
    assert out["rejected"] == {"welch": ["c/auc", "c/dice"], "f": []}
    assert out["verdict"] == "a fault in the level"
    wide = {f"c/seed{s}": {"auc": 0.70 + 0.01 * s, "dice": 0.15 + 0.04 * (s - 2)}
            for s in range(5)}
    out = band.two_sample(wide, jax, ["c"])
    assert out["rejected"] == {"welch": [], "f": ["c/dice"]}
    assert out["verdict"] == "a fault in the spread"
    one = band.two_sample({"c/seed1": jax["c/seed1"]}, jax, ["c"])
    assert one["cells"] == {} and one["verdict"] == "no cell with two seeds a side"
