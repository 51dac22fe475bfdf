"""The port under `rng: "jax"` against the JAX package on the same seeds:
flax's init, the trainer's key schedule and the detector's.

- `jax_init_state_dict` against `jax.jit(model.init)` at the key the JAX
  trainer uses, leaf by leaf: zeros and ones exact, each lecun_normal
  kernel within 8 ulps of 1.0 times its scale s = sqrt(1/fan_in) / .8796
  (the erfinv bound of `tests/test_torch_jax_random.py`; 8.9 measured at
  args256syn64s2d's full width).
- `train.train` at 32^2 in fp32, epochs 0 and 1 with the epoch-0 VLB
  sweep, at 1 and 2 substeps a dispatch: the t and the simplex seeds of
  every step equal the JAX trainer's (derived here with `jax.random` from
  its code: the loop key, a split per substep, `fold_in(step)`, a split in
  three; the loop key split after the sweep); the epoch-0 loss and the
  VLB within 1e-4 relative; every parameter within 1e-4 of its tensor's
  largest magnitude plus one ulp plus 1e-3 lr (Adam turns the gradients'
  rounding into an error of the update relative to lr, up to 4.2e-4 lr
  measured where the gradient is at least 1e-3 of its tensor's largest),
  except where a gradient was near 0 (at some step at most 1e-3 of its
  tensor's largest, or the whole tensor's rounding noise at most 1e-6 of
  the largest gradient: the time projections and biases that feed
  single-channel GroupNorm groups, whose true gradient is 0).  There Adam's step of up to lr has a sign set
  by rounding: held to lr, 0.06 lr measured; 7-16% of the elements.
- `detect.anomalous_metric_calculation` at 32^2 on the same weights under
  DDPM, DDIM at eta 1 and 2 reconstructions a group, with Gaussian and
  simplex noise: the key of every draw (the q-jump's, each reverse
  step's) equals the one the JAX detector's code splits off for it, bit
  for bit, and each group's reconstruction stands against JAX's by
  `RECON_RULE` (within 1e-4 nearly everywhere; the rule says where not).
- The noise kinds without a JAX stream in the port raise under a JaxKey.
- The campaigns: the JAX-stream recipe of `seed_replication` (`--rng jax`)
  and `band --jax-rng`'s paired verdicts on fixtures.
"""
import contextlib
import io
import json
import pathlib
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anoddpm_tpu import detect as jdetect
from anoddpm_tpu import train as jtrain
from anoddpm_tpu.config import defaultdict_from_json
from anoddpm_tpu.models.unet import unet_from_args as jax_unet_from_args
from anoddpm_tpu.schedule import get_beta_schedule, make_schedule
from anoddpm_tpu.training import EvalModel
from anoddpm_torch import detect as tdetect
from anoddpm_torch import diffusion as tdm
from anoddpm_torch import schedule as ts
from anoddpm_torch import streams
from anoddpm_torch import train as ttrain
from anoddpm_torch.campaigns import band, seed_replication
from anoddpm_torch.campaigns._results import load_results, save_results
from anoddpm_torch.compat import jax_random as jr
from anoddpm_torch.compat.flax_init import jax_init_state_dict
from anoddpm_torch.compat.flax_params import unet_state_dict_from_flax
from anoddpm_torch.config import load_args
from anoddpm_torch.ops import noise as tnoise
from torch_parity import CONFIGS, flax_and_port

TRUNCATED_ULPS = 8
LR = 1e-4
SEED = 3
SMOKE = {"arg_num": "tjax", "img_size": [32, 32], "Batch_Size": 2,
         "EPOCHS": 1, "T": 10, "base_channels": 32, "channel_mults": [1, 2],
         "attention_resolutions": "16", "beta_schedule": "cosine",
         "loss-type": "l2", "lr": LR, "sample_distance": 8,
         "train_start": True, "noise_fn": "simplex", "dataset": "synthetic",
         "iters_per_epoch": 2, "checkpoint_every": 1000, "save_imgs": False,
         "save_vids": False, "seed": SEED, "compute_dtype": "float32",
         "skip_test_eval": True}
MAX_T = 8


def _flax_init(args, seed):
    """The port-named parameters of the JAX UNet's init under the JAX
    trainer's key, split(key(seed))[1]."""
    img = args["img_size"][0]
    fmodel = jax_unet_from_args(args, 1)
    _, init_key = jax.random.split(jax.random.key(seed))
    b = int(args.get("Batch_Size") or 1)
    params = jax.jit(fmodel.init)(init_key, jnp.zeros((b, img, img, 1), jnp.float32),
                                  jnp.zeros((b,), jnp.int32))
    return {k: v.numpy() for k, v in unet_state_dict_from_flax(params).items()}


def _assert_init_matches(args, seed):
    want = _flax_init(args, seed)
    got = {k: v.numpy() for k, v in jax_init_state_dict(args, seed).items()}
    assert sorted(got) == sorted(want)
    kernels = 0
    for k, w in want.items():
        assert got[k].shape == w.shape, k
        if not w.any() or (w == 1).all():
            np.testing.assert_array_equal(got[k], w, err_msg=k)
            continue
        kernels += 1
        s = np.sqrt(1.0 / np.prod(w.shape[1:])) / 0.87962566103423978
        err = np.abs(got[k].astype(np.float64) - w).max()
        assert err <= TRUNCATED_ULPS * 2 ** -23 * s, (k, err / (2 ** -23 * s))
    assert kernels > 10


@pytest.mark.parametrize("name", ["s2d1", "s2d2"])
def test_init_matches_flax_at_32(name):
    cfg = CONFIGS[name]
    args = {"img_size": [32, 32], "base_channels": cfg["base_channels"],
            "channel_mults": ",".join(str(m) for m in cfg["channel_mults"]),
            "attention_resolutions": cfg["attention_resolutions"],
            "space_to_depth": cfg.get("space_to_depth", 1),
            "compute_dtype": "float32", "Batch_Size": 2}
    _assert_init_matches(defaultdict_from_json(args), 7)


def test_init_matches_flax_at_s2d64_full_width():
    """args256syn64s2d at its full width (24M parameters; init only)."""
    _assert_init_matches(load_args("256syn64s2d"), 2)


def _expected_draws(substeps, epochs=2, iters=2, batch=2):
    """(t, seeds) of every step of the JAX trainer, from its code
    (`anoddpm_tpu/train.py`, `training.py`) run with `jax.random`."""
    key, _ = jax.random.split(jax.random.key(SEED))
    draws, step = [], 0
    for epoch in range(epochs):
        for _ in range(max(iters // substeps, 1)):
            k = key
            for _ in range(substeps):
                if substeps > 1:
                    k, sub = jax.random.split(k)
                else:
                    sub = key
                t_key, noise_key, _ = jax.random.split(
                    jax.random.fold_in(sub, step), 3)
                draws.append((
                    np.asarray(jax.random.randint(t_key, (batch,), 0, MAX_T)).tolist(),
                    np.asarray(jax.random.bits(noise_key, (batch,), jnp.uint32)
                               ).astype(np.int64).tolist()))
                step += 1
        if epoch % 200 == 0:
            key, _ = jax.random.split(key)
    return draws


def _loss_and_vlb(root, stdout):
    with open(f"{root}/metrics/argstjax-train.jsonl") as f:
        loss = json.loads(f.readline())["loss"]
    line = next(l for l in stdout.splitlines() if "total VLB" in l)
    return loss, float(line.split("total VLB: ")[1].split()[0])


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """The JAX trainer at 1 and 2 substeps: epoch-0 loss, VLB, params."""
    runs = {}
    for substeps in (1, 2):
        root = str(tmp_path_factory.mktemp(f"jax{substeps}"))
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            state = jtrain.train(defaultdict_from_json(
                {**SMOKE, "train_substeps": substeps}), root_dir=root)
        params = {k: v.numpy() for k, v in unet_state_dict_from_flax(
            jax.tree_util.tree_map(np.asarray, state.params)).items()}
        runs[substeps] = (_loss_and_vlb(root, out.getvalue()), params)
    return runs


@pytest.mark.parametrize("substeps", [1, 2])
def test_train_draws_and_matches_the_jax_trainer(substeps, jax_runs, tmp_path,
                                                 monkeypatch, capsys):
    drawn = []
    timesteps, seeds = tdm.sample_timesteps, tnoise._seeds
    grads, new_state = {}, ttrain.new_train_state

    def record_grads(args, device):
        state = new_state(args, device)
        for n, p in state.model.named_parameters():
            p.register_post_accumulate_grad_hook(
                lambda p, n=n: grads.setdefault(n, []).append(p.grad.numpy().copy()))
        return state

    monkeypatch.setattr(ttrain, "new_train_state", record_grads)

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
    root = str(tmp_path)
    state = ttrain.train(defaultdict_from_json(
        {**SMOKE, "train_substeps": substeps, "rng": "jax"}), root_dir=root,
        device="cpu")
    assert state.step == 4
    assert [tuple(d) for d in drawn] == [tuple(d) for d in _expected_draws(substeps)]
    (want_loss, want_vlb), want = jax_runs[substeps]
    got_loss, got_vlb = _loss_and_vlb(root, capsys.readouterr().out)
    assert got_loss == pytest.approx(want_loss, rel=1e-4)
    assert got_vlb == pytest.approx(want_vlb, rel=1e-4)
    gmax = [max(np.abs(g[i]).max() for g in grads.values()) for i in range(4)]
    for k, p in state.model.state_dict().items():
        got, w = p.numpy(), want[k]
        # Adam's near-zero-gradient elements: at some step, at most 1e-3 of
        # the tensor's largest gradient, or in a tensor whose gradient is
        # rounding noise (a true gradient of 0, <= 1e-6 of the largest)
        near = np.zeros(w.shape, bool)
        for g, m in zip(grads[k], gmax):
            top = np.abs(g).max()
            if top > 0:
                near |= (np.abs(g) <= 1e-3 * top) | (top <= 1e-6 * m)
        bound = np.where(near, LR, 1e-4 * np.abs(w).max() + np.spacing(np.abs(w))
                         + 1e-3 * LR)
        bad = np.abs(got - w) > bound
        assert not bad.any(), (k, got[bad][:5], w[bad][:5], near[bad][:5])


def test_substeps_draw_differently_under_jax_keys():
    """As in JAX, and unlike a torch.Generator, 1 and 2 steps a dispatch
    draw different t and seeds: the multi-step splits its key."""
    assert _expected_draws(1) != _expected_draws(2)


DETECT = {"arg_num": "tjaxdet", "img_size": [32, 32], "dataset": "synthetic",
          "noise_fn": "simplex", "seed": 4, "anomalous_volumes": 2}


# (share of pixels within 1e-4, largest |difference|) of a group's
# reconstruction.  gauss: the normals stand within 128 ulps of JAX's
# (test_torch_jax_random.py), which DDIM at eta 1 carries to 7.5e-4 at
# 0.1% of pixels (measured; DDPM stays within 1.3e-5).  simplex: the plain
# field equals JAX's within 1e-5 on >= 99.7% of pixels only, a floor()
# flipping at a lattice-cell boundary (tests/test_torch_simplex.py), and
# 20 reverse steps spread those pixels through the UNet: 94.3% within 1e-4
# and 1.2e-3 at most measured.  A wrong key moves every pixel by O(1).
RECON_RULE = {"gauss": (0.999, 1e-3), "simplex": (0.9, 1e-2)}


def _expected_detect_keys(protocol, t_distance):
    """The key words of every draw of the JAX detector, from its code
    (`anoddpm_tpu/detect.py`, `diffusion.py`) run with `jax.random`:
    key(seed + 1) split once per volume group, into one key per
    reconstruction with repeats; each reconstruction splits a q-jump and a
    reverse key, and the reverse key once per reverse step."""
    def words(k):
        return tuple(int(v) for v in np.asarray(jax.random.key_data(k)))
    repeats = int(protocol.get("recon_repeats") or 1)
    steps = int(protocol.get("ddim_steps") or t_distance)
    key, keys = jax.random.key(DETECT["seed"] + 1), []
    for _ in range(DETECT["anomalous_volumes"]):
        key, sub = jax.random.split(key)
        for r in (jax.random.split(sub, repeats) if repeats > 1 else [sub]):
            fwd, k = jax.random.split(r)
            keys.append(words(fwd))
            for _ in range(steps):
                k, step_key = jax.random.split(k)
                keys.append(words(step_key))
    return keys


@pytest.mark.parametrize("noise", ["gauss", "simplex"])
@pytest.mark.parametrize("protocol", [
    {"sampler": "ddpm"},
    {"sampler": "ddim", "ddim_steps": 5, "ddim_eta": 1.0},
    {"sampler": "ddim", "ddim_steps": 4, "ddim_eta": 1.0, "recon_repeats": 2}],
    ids=["ddpm", "ddim_eta1", "ddim_x2"])
def test_detection_matches_jax(protocol, noise, tmp_path, monkeypatch):
    fmodel, params, port = flax_and_port(CONFIGS["s2d1"])
    recons = {"jax": [], "port": []}
    for name, module in (("jax", jdetect), ("port", tdetect)):
        metrics = module.M.batched_anomaly_metrics

        def record(images, recon, masks, _name=name, _metrics=metrics):
            recons[_name].append(np.asarray(recon))
            return _metrics(images, recon, masks)
        monkeypatch.setattr(module.M, "batched_anomaly_metrics", record)
    drawn = []
    for name in ("seeds", "normal"):
        draw = getattr(streams._JaxView, name)

        def record_key(view, *a, _draw=draw):
            drawn.append(view.key.words)
            return _draw(view, *a)
        monkeypatch.setattr(streams._JaxView, name, record_key)
    jdetect.anomalous_metric_calculation(
        args=defaultdict_from_json({**DETECT, **protocol, "noise_fn": noise}), root_dir=str(tmp_path),
        em=EvalModel(fmodel, params),
        sched=make_schedule(get_beta_schedule(20, "cosine")))
    tdetect.anomalous_metric_calculation(
        args=defaultdict_from_json({**DETECT, **protocol, "noise_fn": noise,
                                    "rng": "jax"}),
        root_dir=str(tmp_path), em=port,
        sched=ts.make_schedule(ts.get_beta_schedule(20, "cosine")),
        device="cpu")
    assert len(recons["jax"]) == len(recons["port"]) == 2
    assert drawn == _expected_detect_keys(protocol, 20)
    share, worst = RECON_RULE[noise]
    for want, got in zip(recons["jax"], recons["port"]):
        d = np.abs(got - want)
        assert (d <= 1e-4).mean() >= share and d.max() <= worst, (
            d.max(), (d <= 1e-4).mean())


@pytest.mark.parametrize("kind, kwargs", [
    ("simplex_randParam", {}), ("random", {}), ("simplex_2d", {}),
    ("simplex", {"table": True})])
def test_unported_noise_kinds_raise_under_jax_keys(kind, kwargs):
    sampler = tnoise.make_noise_sampler(kind, **kwargs)
    with pytest.raises(NotImplementedError, match="rng: jax"):
        sampler((1, 1, 8, 8), torch.zeros(1, dtype=torch.int64), jr.key(0))
    # a torch.Generator still draws them
    assert sampler((1, 1, 8, 8), torch.zeros(1, dtype=torch.int64),
                   torch.Generator().manual_seed(0)).shape == (1, 1, 8, 8)


def test_gaussian_and_simplex_draw_the_jax_samplers_keys():
    """gauss: JAX's NHWC normal, transposed; simplex: K1's seeds are
    bits(key, (B * C,)), as the JAX sampler's hash seeds."""
    from anoddpm_tpu.ops.simplex import seeds_from_key
    key = jr.key(9).split(3)[2]
    jkey = jax.random.split(jax.random.key(9), 3)[2]
    got = tnoise.gaussian_noise((2, 3, 4, 5), None, key).numpy()
    want = np.asarray(jax.random.normal(jkey, (2, 4, 5, 3))).transpose(0, 3, 1, 2)
    assert np.abs(got - want).max() <= 128 * np.spacing(np.abs(want)).max()
    assert tnoise._seeds(6, key).tolist() == np.asarray(
        seeds_from_key(jkey, 6)).astype(np.int64).tolist()


# --- the campaigns: seeds on the JAX streams, and F3 paired -----------------

ROOT = pathlib.Path(__file__).resolve().parent.parent


def test_jax_rng_recipe_tokens_and_files():
    args = seed_replication.train_args_for("256syn64s2d", 3, str(ROOT), "jax_rng")
    assert args["arg_num"] == "256syn64s2d_s3_jaxrng"
    assert (args["rng"], args["norm_impl"], args["bf16_norm"],
            args["train_substeps"]) == ("jax", "flax", False, 8)
    assert seed_replication.results_name([0, 1], "jax_rng") == \
        "results/torch_f3_jax_rng_seeds01.json"
    assert "rng" not in seed_replication.train_args_for(
        "256syn64s2d", 3, str(ROOT), "flax")


def test_seed_replication_cli_rng_jax(tmp_path):
    """`--rng jax` trains in the JAX-stream recipe and writes the seed's
    entries to its own file; with `--norm-order kernel` it is refused."""
    orders = []

    def trained(c, s, r, d, o):
        orders.append(o)
        return f"{c}_s{s}"

    def metric(args, root_dir, em, sched, device):
        return {m: 0.5 for m in seed_replication.METRICS}

    with mock.patch.object(seed_replication, "ensure_trained", trained), \
            mock.patch.object(seed_replication, "_load_eval_model",
                              lambda r, t, device: ({}, None, None)), \
            mock.patch.object(seed_replication, "anomalous_metric_calculation",
                              metric):
        res = seed_replication.main(["2", "--skip=paper128", "--rng", "jax",
                                     "--root", str(tmp_path)], device="cpu")
        with pytest.raises(SystemExit):
            seed_replication.main(["2", "--rng", "jax", "--norm-order",
                                   "kernel", "--root", str(tmp_path)],
                                  device="cpu")
    assert orders == ["jax_rng"]
    assert load_results(str(tmp_path), "results/torch_f3_jax_rng_seeds2.json") == res


def _paired_fixture(root, port_of, paired=(0, 1, 2, 3, 4)):
    """JAX-stream seed files (one per seed) whose value in each cell and
    metric is `port_of(cell, metric, seed, jax_value)`, and the epoch-0
    gate marking `paired`."""
    with open(ROOT / "results" / "seed_replication.json") as f:
        jax = json.load(f)
    cells = [c for c in seed_replication.MODELS["256syn64s2d"]
             if f"{c}/aggregate" in jax]
    for s in range(5):
        save_results(str(root), f"results/torch_f3_jax_rng_seeds{s}.json", {
            f"{c}/seed{s}": {m: port_of(c, m, s, jax[f"{c}/seed{s}"][m])
                             for m in ("auc", "dice", "iou", "ssim")}
            for c in cells})
    save_results(str(root), band.EPOCH0_GATE, {"seeds": {
        str(s): {"paired": s in paired} for s in range(5)}})
    return cells


@pytest.mark.parametrize("case,verdict", [
    ("twins", "closed: the draws"),
    ("wide", "a fault in the port"),
    ("shuffled", "open: the pairs do not hold"),
    ("three", "open: the streams could not be reproduced")])
def test_band_jax_rng_paired_verdicts(tmp_path, case, verdict):
    """`band --jax-rng` by the rule of PERF.md section 2: each JAX seed's
    twin within a tenth of a JAX sigma closes F3 as the draws; DDIM-20
    Dice spread 7x wider fails P1; twins that sit further from their JAX
    seed than the JAX seeds sit from each other (the values handed to
    another seed) carry nothing; fewer than 4 paired seeds leave it open."""
    wide = [0.03, -0.025, 0.02, -0.03, 0.028]

    def port_of(cell, metric, seed, value):
        if case == "shuffled":
            with open(ROOT / "results" / "seed_replication.json") as f:
                jax = json.load(f)
            return jax[f"{cell}/seed{(seed + 2) % 5}"][metric]
        if case == "wide" and (cell, metric) == band.F3_CELL:
            return value + wide[seed]
        return value + 1e-4 * (seed - 2)

    _paired_fixture(tmp_path, port_of,
                    (0, 1, 2) if case == "three" else (0, 1, 2, 3, 4))
    out = band.main(["--root", str(tmp_path), "--jax-rng"])
    assert load_results(str(tmp_path), "results/torch_f3_jax_rng_paired.json") \
        == json.loads(json.dumps(out))
    assert out["verdict"].startswith(verdict)
    row = out["cells"]["s2d64_ddim20_eta1"]["dice"]
    assert set(row) >= {"mean", "max_abs", "pearson_r", "paired_t_p",
                        "sigma_jax", "mean_abs_over_sigma"}
    if case != "three":
        assert len(out["holm"]) == 16 and out["seeds"] == [0, 1, 2, 3, 4]
    if case == "wide":
        assert "P1" in out["verdict"]


def test_test_set_suite_matches_jax(tmp_path):
    """`evaluation.testing` on the JAX streams: key(0) split once per batch
    of the VLB pass and of the PSNR pass, as in JAX; Gaussian noise, two
    batches of 2 each, every mean within 1e-4 relative."""
    import itertools
    from anoddpm_tpu.evaluation import testing as jax_testing
    from anoddpm_tpu.ops.noise import make_noise_sampler as jax_sampler
    from anoddpm_torch.evaluation import testing
    fmodel, params, port = flax_and_port(CONFIGS["s2d1"])
    images = np.random.default_rng(3).uniform(-1, 1, (2, 32, 32, 1)).astype(np.float32)
    args = {"arg_num": "tjaxtest", "sample_distance": 20}
    want = jax_testing(itertools.cycle([{"image": images}]),
                       EvalModel(fmodel, params),
                       make_schedule(get_beta_schedule(20, "cosine")),
                       defaultdict_from_json(args),
                       noise_sampler=jax_sampler("gauss"),
                       root_dir=str(tmp_path / "jax"), n_images=4,
                       save_videos=False)
    got = testing(itertools.cycle([{"image": images}]), port,
                  ts.make_schedule(ts.get_beta_schedule(20, "cosine")),
                  defaultdict_from_json({**args, "rng": "jax"}),
                  noise_sampler=tnoise.make_noise_sampler("gauss"),
                  root_dir=str(tmp_path / "port"), n_images=4)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        # a std over two batches is a difference of two means: held to
        # 1e-4 of its mean; prior_vlb (~1e-6, no draws) to 1e-7
        tol = (dict(abs=1e-4 * abs(want[k[:-4]])) if k.endswith("_std")
               else dict(rel=1e-4, abs=1e-7))
        assert got[k] == pytest.approx(v, **tol), k


def test_entry_points_without_jax_streams_raise():
    """The detection sweeps and figures whose JAX key schedules the port
    does not follow refuse `rng: "jax"` rather than draw torch's streams."""
    from anoddpm_torch import figures as tfigures
    args = defaultdict_from_json({**DETECT, "rng": "jax"})
    x = np.zeros((1, 32, 32, 1), np.float32)
    for call in (lambda: tdetect.detection_A(args, None, None, x, x, "f"),
                 lambda: tdetect.detection_B(args, None, None, x, x, "f"),
                 lambda: tdetect.detection_A_fixedT(args, None, None, x, x),
                 lambda: tfigures.ano_outputs(args, None, None),
                 lambda: tfigures.gauss_varying_t(args, None, None)):
        with pytest.raises(NotImplementedError, match="rng: jax"):
            call()
