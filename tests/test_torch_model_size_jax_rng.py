"""args256syn64, the JAX package's model-size token, on the JAX package's
streams: its recipe, its trainer against the JAX trainer, and the rule
that pairs it with `results/model_size_quality.json`.

- `model_size_quality.RECIPE` is what configs/args256syn64.json and the
  JAX train CLI give the token (1 step a dispatch, dropout 0, EMA 0.9999,
  bf16, GroupNorm in fp32 cast to bf16 before SiLU) as
  `scripts/torch_model_size_jax_code.py` recorded it in the JAX code that
  wrote the file (`results/torch_model_size_jax_code.json`); `model_args`
  and the config `--write-config` writes give the train CLI that recipe.
- `train.train` on that recipe at 32^2 (the config's base 64 and heads,
  mults 1 2, attention at 16, T 20, 3 steps at batch 2) against today's
  JAX trainer: every step's t and simplex seeds equal the JAX trainer's
  (derived from its code: the loop key split(key(seed))[0] itself at 1
  step a dispatch, fold_in(step), a split in three), the epoch-0 loss and
  VLB within 1e-4 relative (the rule of
  `test_train_draws_and_matches_the_jax_trainer`).
- `paired_verdict` on fixtures takes each of its four verdicts, and
  `--paired` on the committed files recomputes the committed verdict.
"""
import contextlib
import io
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anoddpm_tpu import train as jtrain
from anoddpm_tpu.config import defaultdict_from_json
from anoddpm_tpu.models.unet import unet_from_args as jax_unet_from_args
from anoddpm_torch import diffusion as tdm
from anoddpm_torch import train as ttrain
from anoddpm_torch.campaigns import model_size_quality as msq
from anoddpm_torch.campaigns._results import load_results
from anoddpm_torch.config import load_args
from anoddpm_torch.models.unet import NormSiLU, unet_from_args
from anoddpm_torch.ops import noise as tnoise

ROOT = pathlib.Path(__file__).resolve().parent.parent
CONFIG = ROOT / "configs" / "args256syn64.json"
CUT = {"img_size": [32, 32], "channel_mults": [1, 2],
       "attention_resolutions": "16", "T": 20, "sample_distance": 16,
       "Batch_Size": 2, "iters_per_epoch": 3}


def _raw():
    with open(CONFIG) as f:
        return json.load(f)


# --- the recipe -----------------------------------------------------------------

def test_recipe_is_what_the_jax_code_found():
    """Each key of RECIPE against the JAX trainer's own record (the first
    tree, 75887cc, and today's agree on it) and the config."""
    code = load_results(str(ROOT), msq.CODE_FILE)
    found = code["recipe"]
    raw = _raw()
    assert "train_substeps" not in raw and found["dispatch"] == "jit_train_step"
    assert msq.RECIPE["train_substeps"] == 1
    assert raw["dropout"] == msq.RECIPE["dropout"] == 0
    assert found["train_step"]["dropout"] is False
    assert found["train_step"]["ema_decay"] == msq.RECIPE["ema_decay"] == 0.9999
    assert raw["compute_dtype"] == msq.RECIPE["compute_dtype"] == "bfloat16"
    assert "bfloat16" in found["model"]["dtype"]
    assert found["optimizer"] == {"lr": raw["lr"], "weight_decay": 0.0,
                                  "grad_clip": 1.0}
    # the norm: flax's GroupNorm in fp32 cast back to the activation dtype,
    # then SiLU in bf16, which is the port's flax order with bf16_norm off
    src = found["norm_site_source"]
    assert "dtype=jnp.float32" in src and ".astype(x.dtype)" in src
    assert (msq.RECIPE["norm_impl"], msq.RECIPE["bf16_norm"],
            msq.RECIPE["pallas_norm"]) == ("flax", False, False)
    for tree, cmp in code["against"].items():
        assert cmp["norm site"]["equal"], tree
    assert all(v["bit_equal_share"] == 1.0 and v["dtype"] == "bfloat16"
               for v in code["port_norm_site"].values())


def test_model_args_and_written_config_carry_the_recipe(tmp_path):
    """`model_args` is the config plus RECIPE on the JAX streams; the
    config `--write-config` writes loads as the same args; the JAX train
    CLI builds its UNet from the config without bf16_norm or pallas_norm,
    and the port's from the token in the flax order with both off."""
    args = msq.model_args("256syn64", str(ROOT))
    base = load_args("256syn64", config_dir=str(ROOT / "configs"))
    for k, v in base.items():
        if k not in msq.RECIPE and k not in msq.JAX_STREAMS and k != "arg_num":
            assert args[k] == v, k
    assert {k: args[k] for k in msq.RECIPE} == msq.RECIPE
    assert (args["rng"], args["seed"], args["arg_num"]) == ("jax", 0,
                                                           "256syn64_jaxrng")
    (tmp_path / "configs").mkdir()
    (tmp_path / "configs" / "args256syn64.json").write_text(CONFIG.read_text())
    msq.main(["--write-config", "256syn64", "--root", str(tmp_path)])
    written = load_args("256syn64_jaxrng", config_dir=str(tmp_path / "configs"))
    assert dict(written) == dict(args)
    jmodel = jax_unet_from_args(defaultdict_from_json(_raw()), 1)
    assert (jmodel.bf16_norm, jmodel.pallas_norm, jmodel.dtype) == (
        False, False, jnp.bfloat16)
    with torch.device("meta"):
        model = unet_from_args(written, 1)
    sites = [m for m in model.modules() if isinstance(m, NormSiLU)]
    assert len(sites) == 85
    assert all((m.norm_impl, m.bf16_norm) == ("flax", False) for m in sites)


# --- the trainer against the JAX trainer -----------------------------------------

def _expected_draws(seed, steps, batch, max_t):
    """(t, seeds) of the JAX trainer's first `steps` steps at 1 step a
    dispatch, from its code (`anoddpm_tpu/train.py`, `training.py`)."""
    loop_key, _ = jax.random.split(jax.random.key(seed))
    draws = []
    for step in range(steps):
        t_key, noise_key, _ = jax.random.split(jax.random.fold_in(loop_key, step), 3)
        draws.append((
            np.asarray(jax.random.randint(t_key, (batch,), 0, max_t)).tolist(),
            np.asarray(jax.random.bits(noise_key, (batch,), jnp.uint32)
                       ).astype(np.int64).tolist()))
    return draws


def _loss_and_vlb(root, token, stdout):
    with open(f"{root}/metrics/args{token}-train.jsonl") as f:
        loss = json.loads(f.readline())["loss"]
    line = next(l for l in stdout.splitlines() if "total VLB" in l)
    return loss, float(line.split("total VLB: ")[1].split()[0])


@pytest.fixture
def two_threads():
    """torch on 2 threads for the test: beside the test run's other
    workers, 8 OpenMP threads a process oversubscribe the cores and every
    worker's training slows several-fold (two heavy files at once took
    over 400 s, against 108 s at 4 threads each, on an 8-core host)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_epoch0_matches_the_jax_trainer(tmp_path, monkeypatch, capsys,
                                        two_threads):
    args = msq.model_args("256syn64", str(ROOT))
    args.update(CUT)
    args["img_size"] = tuple(CUT["img_size"])
    jax_args = {k: v for k, v in args.items() if k != "rng"}
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        jtrain.train(defaultdict_from_json(jax_args), root_dir=str(tmp_path / "jax"),
                     max_epochs=0)
    want_loss, want_vlb = _loss_and_vlb(tmp_path / "jax", args["arg_num"],
                                        out.getvalue())
    drawn = []
    timesteps, seeds = tdm.sample_timesteps, tnoise._seeds

    def record_t(generator, b, max_t):
        t = timesteps(generator, b, max_t)
        drawn.append([t.tolist()])
        return t

    def record_seeds(n, generator):
        s = seeds(n, generator)
        drawn[-1].append(s.tolist())
        return s

    monkeypatch.setattr(tdm, "sample_timesteps", record_t)
    monkeypatch.setattr(tnoise, "_seeds", record_seeds)
    state = ttrain.train(args, root_dir=str(tmp_path / "port"), max_epochs=0,
                         device="cpu")
    steps = CUT["iters_per_epoch"]
    assert state.step == steps
    assert [tuple(d) for d in drawn] == _expected_draws(
        0, steps, CUT["Batch_Size"], CUT["sample_distance"])
    got_loss, got_vlb = _loss_and_vlb(tmp_path / "port", args["arg_num"],
                                      capsys.readouterr().out)
    assert got_loss == pytest.approx(want_loss, rel=1e-4)
    assert got_vlb == pytest.approx(want_vlb, rel=1e-4)


# --- the paired rule --------------------------------------------------------------

SIGMA = {"auc": 0.0195, "dice": 0.0225}


def _jax_rows():
    jax_all = load_results(str(ROOT), msq.JAX_FILE)
    return {p: jax_all[f"256syn64/{p}"] for p, _ in msq.PROTOCOLS}


@pytest.mark.parametrize("case,verdict", [
    ("code", "open: the round-1 code is not today's"),
    ("fault", "a fault in the port: ddim15_eta1, dice"),
    ("closed", "closed: the model size pairs"),
    ("p1", "open: the trajectories part"),
    ("one_sigma", "open: the trajectories part"),
])
def test_paired_verdict_takes_each_branch(case, verdict):
    jax = _jax_rows()
    shift = {"closed": {}, "code": {},
             "fault": {("ddim15_eta1", "dice"): 0.046},
             "p1": {("ddpm200", "auc"): 0.0099},
             "one_sigma": {("ddim25_eta1", "auc"): -0.0196}}[case]
    port = {p: {m: v + shift.get((p, m), 0.004) for m, v in row.items()}
            for p, row in jax.items()}
    res = msq.paired_verdict(port, jax, SIGMA,
                             "dba8c08: scores" if case == "code" else None)
    assert res["verdict"].startswith(verdict)
    assert res["delta"]["ddpm200"]["dice"] == pytest.approx(
        shift.get(("ddpm200", "dice"), 0.004))


def test_sigma_is_the_five_jax_seeds():
    sigma = msq.jax_sigma(str(ROOT))
    assert sigma["auc"] == pytest.approx(0.0195, abs=5e-5)
    assert sigma["dice"] == pytest.approx(0.0225, abs=5e-5)


@pytest.mark.parametrize("config", ["256syn64", "256syn128"])
def test_paired_file_recomputes(tmp_path, config):
    """`--paired` over the committed port and JAX files gives the committed
    paired file, verdict and all, for the model-size token and the
    control."""
    committed = load_results(str(ROOT), msq.paired_file(config))
    for rel in (msq.JAX_FILE, msq.CODE_FILE, msq.PORT_FILE, msq.JAX_SEEDS,
                msq.PORT_PAPER_SEEDS):
        (tmp_path / rel).parent.mkdir(parents=True, exist_ok=True)
        (tmp_path / rel).write_bytes((ROOT / rel).read_bytes())
    res = msq.main(["--paired", "--config", config, "--root", str(tmp_path)])
    assert res == committed and res["verdict"] == committed["verdict"]
