"""The port's measuring entry points on the CPU at small sizes:
`anoddpm_torch.bench` against `bench.py` (the protocol main() passes, the
keys it prints, the FLOP count against XLA's cost model of the flax UNet),
and the campaigns chain_flops, mfu_push, bf16_norm_ab, substep_probe and
trace_categories."""
import importlib.util
import inspect
import json
import os
import pathlib
from unittest import mock

import jax
import jax.numpy as jnp
import pytest
import torch

from anoddpm_tpu.models.unet import UNet as FlaxUNet
from anoddpm_torch import bench
from anoddpm_torch.campaigns import (bf16_norm_ab, chain_flops, mfu_push,
                                     seed_replication, substep_probe,
                                     trace_categories)
from anoddpm_torch.models.unet import UNet

ROOT = pathlib.Path(__file__).resolve().parent.parent
FLAX_NORM = dict(norm_impl="flax")
# bench.py's UNet (attention at 16 and 8, 2 heads, bf16) at three sizes:
# (img, base, s2d, channel_mults, the port's FLOPs within this share of
# XLA's); batch 2.  FlopCounterMode counts convolutions and matmuls, XLA's
# cost model every op: the elementwise work is a larger share of the small
# nets'.
FLOP_CASES = [(32, 64, 1, (1, 2), 0.05), (64, 64, 2, (1, 2, 2), 0.05),
              (256, 64, 2, (), 0.01)]
# the small config of the CPU runs below
SMALL = dict(img=32, base_channels=32)


def xla_flops(fn, *args):
    return jax.jit(fn).lower(*args).compile().cost_analysis()["flops"]


@pytest.mark.parametrize("img,base,s2d,mults,share", FLOP_CASES)
def test_forward_flops_match_xla(img, base, s2d, mults, share):
    """`FlopCounterMode` over the port's forward (on the meta device, no
    compute) against `cost_analysis()["flops"]` of the flax UNet's forward
    (at the headline shape 73.416 and 73.481 GFLOP)."""
    cfg = dict(img_size=img, base_channels=base, in_channels=1,
               channel_mults=mults, attention_resolutions="16,8", n_heads=2,
               space_to_depth=s2d)
    fmodel = FlaxUNet(**cfg, bf16_norm=True, dtype=jnp.bfloat16)
    x, t = jnp.zeros((2, img, img, 1)), jnp.zeros((2,), jnp.int32)
    params = jax.eval_shape(fmodel.init, jax.random.key(0), x, t)
    want = xla_flops(lambda p, a, b: fmodel.apply(p, a, b), params, x, t)
    with torch.device("meta"):
        port = UNet(**cfg, dtype=torch.bfloat16, **FLAX_NORM)
        tx, tt = torch.zeros((2, 1, img, img)), torch.zeros((2,), dtype=torch.int64)
    got = bench.count_flops(lambda: port(tx, tt))
    assert abs(got / want - 1) <= share, (got, want)
    if not mults:
        assert got == bench.unet_fwd_flops(2, base, s2d, img, FLAX_NORM, "meta")


def test_train_step_flops_beside_xla():
    """One train step at 32^2 (base 64, mults (1, 2), batch 2): the port's
    count (convolutions and matmuls, forward and backward: 20.527 GFLOP) is
    96.2% of XLA's cost model of the JAX single-step program (21.330), which
    also counts the simplex noise, the loss, the clip, AdamW and the EMA
    elementwise; held to 0.9-1.0.  The step is 3.00 forwards by the port's
    count (3.15 by XLA's)."""
    from anoddpm_tpu.ops.noise import make_noise_sampler
    from anoddpm_tpu.schedule import get_beta_schedule, make_schedule
    from anoddpm_tpu.training import (init_train_state, make_optimizer,
                                      make_train_step)
    cfg = dict(img_size=32, base_channels=64, in_channels=1, channel_mults=(1, 2),
               attention_resolutions="16,8", n_heads=2)
    fmodel = FlaxUNet(**cfg, bf16_norm=True, dtype=jnp.bfloat16)
    tx = make_optimizer(1e-4)
    state = jax.eval_shape(lambda k: init_train_state(fmodel, tx, k, (2, 32, 32, 1)),
                           jax.random.key(0))
    step = make_train_step(fmodel, make_schedule(get_beta_schedule(1000, "linear")),
                           tx, make_noise_sampler("simplex"), max_t=800)
    want = xla_flops(step, state, jnp.zeros((2, 32, 32, 1)), jax.random.key(0))
    torch.manual_seed(0)
    port = UNet(**cfg, dtype=torch.bfloat16)
    got = bench.train_step_flops(port, 2, 32)
    with torch.device("meta"):
        fwd = bench.count_flops(lambda: UNet(**cfg, dtype=torch.bfloat16,
                                             **FLAX_NORM)(
            torch.zeros((2, 1, 32, 32)), torch.zeros((2,), dtype=torch.int64)))
    assert 0.9 <= got / want <= 1.0, (got, want)
    assert 2.95 <= got / fwd <= 3.05, (got, fwd)


def test_run_bench_and_train_bench_on_cpu():
    sps, spread = bench.run_bench(2, t_distance=4, repeats=2, ddim_steps=2,
                                  device="cpu", **SMALL)
    assert sps > 0 and spread["n"] == 2 and len(spread["sec"]) == 2
    assert spread["sps_iqr"][0] <= sps <= spread["sps_iqr"][1]
    sps, _ = bench.run_bench(2, t_distance=3, repeats=1, device="cpu",
                             norm=dict(norm_impl="flax", bf16_norm=True), **SMALL)
    assert sps > 0
    ips, mfu = bench.run_train_bench(2, 32, 32, substeps=2, repeats=1,
                                     device="cpu")
    assert ips > 0 and mfu is None       # the MFU is the card's alone
    probe = bench.train_probe(2, 32, 32, substeps=2, repeats=1, remat="dots",
                              norm=dict(norm_impl="flax"), device="cpu")
    assert probe["tflop_per_step"] > 0 and probe["remat"] == "dots"
    with pytest.raises(ValueError):
        bench.train_probe(2, 32, 32, remat="all", device="cpu")


def load_jax_bench():
    """bench.py as a module; the environment it sets at import is undone."""
    spec = importlib.util.spec_from_file_location("jax_bench", ROOT / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    with mock.patch.dict(os.environ):
        spec.loader.exec_module(mod)
    return mod


def recorded_main(mod, main_kwargs, env):
    """(calls, printed line) of mod.main() with run_bench and
    run_train_bench replaced by recorders of their bound arguments."""
    calls = []

    def recorder(name, fn, result):
        sig = inspect.signature(fn)

        def record(*a, **k):
            bound = sig.bind(*a, **k)
            bound.apply_defaults()
            calls.append((name, dict(bound.arguments)))
            return result
        return record

    spread = {"n": 5, "sps_iqr": (1.0, 2.0)}
    with mock.patch.dict(os.environ, env, clear=False), \
            mock.patch.object(mod, "run_bench",
                              recorder("bench", mod.run_bench, (1.5, spread))), \
            mock.patch.object(mod, "run_train_bench",
                              recorder("train", mod.run_train_bench, (3.0, 0.5))), \
            mock.patch("builtins.print") as printed:
        mod.main(**main_kwargs)
    return calls, json.loads(printed.call_args[0][0])


@pytest.mark.parametrize("quick", [False, True])
def test_main_follows_bench_py(quick, monkeypatch):
    """bench.main() passes bench.py's protocol arguments to the same cells
    in the same order, in full and quick mode (BENCH_* unset but QUICK),
    prints bench.py's keys, and adds the norm path, the card and the peak."""
    for k in [k for k in os.environ if k.startswith("BENCH_")]:
        monkeypatch.delenv(k)
    env = {"BENCH_QUICK": "1" if quick else "0"}
    want_calls, want_line = recorded_main(load_jax_bench(), {}, env)
    got_calls, got_line = recorded_main(bench, {"device": "cpu"}, env)
    port_only = {"norm", "device"}
    assert [(n, {k: v for k, v in a.items() if k not in port_only})
            for n, a in got_calls] == want_calls
    assert all(a["norm"] == dict(norm_impl="kernel", bf16_norm=True,
                                 pallas_norm=False) for _, a in got_calls)
    assert set(want_line) <= set(got_line)
    assert len(want_calls) == (1 if quick else 5)
    assert got_line["peak_tflops_bf16"] == 989.4 and got_line["device"] == "cpu"
    assert "197" not in json.dumps(got_line)


def test_main_reads_the_norm_knobs(monkeypatch):
    for k in [k for k in os.environ if k.startswith("BENCH_")]:
        monkeypatch.delenv(k)
    env = {"BENCH_QUICK": "1", "BENCH_NORM_IMPL": "flax", "BENCH_BF16_NORM": "0",
           "BENCH_PALLAS_NORM": "1"}
    calls, line = recorded_main(bench, {"device": "cpu"}, env)
    assert calls[0][1]["norm"] == line["norm"] == dict(
        norm_impl="flax", bf16_norm=False, pallas_norm=True)


def test_chain_flops(tmp_path):
    out = chain_flops.run(str(tmp_path), "cpu", rows={"tiny": (2, 32, 1)}, img=32)
    row = json.loads((tmp_path / chain_flops.RESULTS).read_text())["tiny"]
    assert row == out["tiny"]
    per_img = bench.unet_fwd_flops(2, 32, 1, 32, device="cpu") / 2
    assert row["fwd_flops_per_img"] == per_img
    assert row["ddpm200_tflop_per_slice"] == pytest.approx(200 * per_img / 1e12)
    assert row["ddim15_max_slices_per_sec_100mfu"] == pytest.approx(
        989.4e12 / (15 * per_img))
    assert set(chain_flops.ROWS) == {"paper_b8", "headline_b32_s2d"}


def test_mfu_push(tmp_path):
    row = mfu_push.main(["2", "0", "32", "1", "dots", "1", "1", "flax",
                         "--root", str(tmp_path)], device="cpu", img=32,
                        substeps=2, repeats=1)
    lines = (tmp_path / mfu_push.RESULTS).read_text().splitlines()
    assert json.loads(lines[-1]) == row
    assert (row["batch"], row["bf16_norm"], row["remat"], row["pallas_norm"],
            row["norm_impl"]) == (2, False, "dots", True, "flax")
    assert row["mfu"] is None and row["tflop_per_step"] > 0
    with pytest.raises(ValueError, match="unroll"):
        mfu_push.main(["2", "1", "32", "1", "none", "2"], device="cpu")


def test_bf16_norm_ab_timings(tmp_path):
    res = bf16_norm_ab.run_timings(
        str(tmp_path), "cpu",
        train_kw=dict(img=32, base=32, substeps=2, repeats=1),
        infer_kw=dict(img=32, base=32, s2d=1, t_distance=4, ddim_steps=2,
                      repeats=1))
    assert {f"{k}/{p}" for k in ("train", "infer") for p in bf16_norm_ab.PATHS} \
        <= set(res)
    assert all(res[f"train/{p}"]["ms_per_step"] > 0 for p in bf16_norm_ab.PATHS)
    saved = json.loads((tmp_path / bf16_norm_ab.RESULTS).read_text())
    assert saved == json.loads(json.dumps(res))
    with mock.patch.object(bf16_norm_ab, "time_train_step") as again:
        bf16_norm_ab.run_timings(str(tmp_path), "cpu")
    again.assert_not_called()       # a rerun skips the entries it has


def test_bf16_norm_ab_quality_cell(tmp_path):
    """--quality trains args256syn64s2d on the flax bf16 path at 8 substeps
    and scores DDIM-25 eta = 1 into the seed-replication file's
    s2d64_ddim25_eta1_bf16norm cell, aggregated there."""
    (tmp_path / "configs").mkdir()
    cfg = json.loads((ROOT / "configs" / "args256syn64s2d.json").read_text())
    (tmp_path / "configs" / "args256syn64s2d.json").write_text(json.dumps(cfg))
    (tmp_path / "results").mkdir()
    (tmp_path / "results" / "torch_seed_replication.json").write_text(
        json.dumps({"s2d64_ddim25_eta1/seed1": {"auc": 0.7}}))
    trained, scored = [], []
    fake = {"auc": 0.75, "dice": 0.2, "ssim": 0.6, "iou": 0.1}
    with mock.patch.object(bf16_norm_ab, "train",
                           lambda args, root_dir, device: trained.append(args)), \
            mock.patch.object(bf16_norm_ab._stages, "score",
                              lambda *a: scored.append(a) or fake):
        bf16_norm_ab.main(["--quality", "1", "--root", str(tmp_path)], device="cpu")
    (args,) = trained
    assert (args["norm_impl"], args["bf16_norm"], args["train_substeps"],
            args["seed"], args["arg_num"]) == ("flax", True, 8, 1,
                                               "256syn64s2d_bf16n_s1")
    assert scored[0][1:4] == ("256syn64s2d_bf16n_s1", bf16_norm_ab.PROTOCOL,
                              seed_replication.METRICS)
    res = json.loads((tmp_path / "results" / "torch_seed_replication.json").read_text())
    assert res["s2d64_ddim25_eta1_bf16norm/seed1"] == fake
    assert res["s2d64_ddim25_eta1_bf16norm/aggregate"]["auc"] == {
        "mean": 0.75, "std": 0.0, "n": 1}
    assert res["s2d64_ddim25_eta1/seed1"] == {"auc": 0.7}


def test_substep_probe(tmp_path):
    (tmp_path / "configs").mkdir()
    cfg = {"img_size": [32, 32], "Batch_Size": 2, "EPOCHS": 5, "T": 10,
           "base_channels": 32, "channel_mults": [1, 2],
           "attention_resolutions": "16", "beta_schedule": "cosine",
           "loss-type": "l2", "lr": 1e-4, "sample_distance": 8,
           "train_start": True, "noise_fn": "simplex", "dataset": "synthetic",
           "iters_per_epoch": 4, "checkpoint_every": 1, "seed": 0,
           "compute_dtype": "float32"}
    (tmp_path / "configs" / "argstiny.json").write_text(json.dumps(cfg))
    rows = substep_probe.run((2, 4), str(tmp_path), "cpu", epochs=1, reps=1,
                             config="tiny")
    lines = [json.loads(s) for s in
             (tmp_path / substep_probe.RESULTS).read_text().splitlines()]
    assert lines == json.loads(json.dumps(rows))
    assert [(r["substeps"], r["epochs"], r["iters_per_epoch"]) for r in rows] == \
        [(2, 1, 4), (4, 1, 4)]
    assert all(r["sec_per_epoch"] > 0 for r in rows)


def test_trace_categories(tmp_path, monkeypatch):
    """`trace` sums the kernel events of a Chrome trace by kind, and fails on
    a trace without one (observe.ProfileWindow's on the CPU); `decompose`
    times the forward loss, forward + backward and the steps."""
    from anoddpm_torch.observe import ProfileWindow
    monkeypatch.setenv("ANODDPM_PROFILE_DIR", str(tmp_path / "prof"))
    window = ProfileWindow("train", epoch_index=0)
    window.start_epoch(0)
    torch.ones(4).sum()
    window.end_epoch(0)
    with pytest.raises(ValueError, match="no device kernel"):
        trace_categories.main(["trace", str(tmp_path / "prof")])
    events = [{"ph": "X", "cat": "kernel", "name": n, "dur": d} for n, d in (
        ("group_norm_silu_kernel<bf16>", 30), ("group_norm_silu_bwd", 50),
        ("sm90_xmma_fprop_implicit_gemm", 100), ("octave_field", 20),
        ("vectorized_elementwise_kernel", 10))]
    events.append({"ph": "X", "cat": "cpu_op", "name": "aten::add", "dur": 999})
    (tmp_path / "t" / "train").mkdir(parents=True)
    (tmp_path / "t" / "train" / "trace.json").write_text(
        json.dumps({"traceEvents": events}))
    out = trace_categories.main(["trace", str(tmp_path / "t"), "2"])
    assert out["total_ms"] == pytest.approx(0.21) and out["kernels"] == 5
    assert out["ms_per_step"] == pytest.approx(0.105)
    assert out["kinds_ms"] == pytest.approx({
        "K2 group_norm_silu": 0.03, "K2b group_norm_silu backward": 0.05,
        "conv forward": 0.1, "K1 simplex field": 0.02, "elementwise": 0.01})
    rows = trace_categories.decompose(2, 32, 1, img=32, substeps=2, iters=1,
                                      device="cpu")
    assert rows["forward + backward"]["tflop"] > 2 * rows["forward loss"]["tflop"]
    assert all(r["ms"] > 0 and r["mfu"] is None for r in rows.values())
