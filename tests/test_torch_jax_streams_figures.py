"""The port's figures and args_dptest's training under `rng: "jax"`
against the JAX package on the same keys (the rest of the suite, and the
rules, in `tests/test_torch_jax_streams_suite.py`; the two files run on
separate workers).

- Every figure of `anoddpm_torch/figures.py` against its JAX function at
  32^2, T 20, on the suite's flax model: the key of every draw equals the
  one the JAX figure keys (`anoddpm_tpu/figures.py:142, 243, 266, 288,
  309, 327, 363`) and the JAX chains split, and each sheet's panels stand
  against JAX's by RECON_RULE (a thresholded panel equal on 99% of its
  pixels); `test_set_outputs` from two checkpoints and `ce_outputs` with
  its context encoder trained on the JAX keys.
- args_dptest (dropout .1, loss_weight prop-t, simplex_randParam, 2
  substeps a dispatch): its 2 epochs by both trainers, the t, table row
  and seeds of every step equal, the epoch-0 loss and VLB within the
  1e-4 relative of test_train_draws_and_matches_the_jax_trainer.
"""
import contextlib
import io
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from anoddpm_tpu import figures as jfigures
from anoddpm_tpu.config import defaultdict_from_json
from anoddpm_tpu.ops import simplex as jsx
from anoddpm_torch import figures as tfigures
from anoddpm_torch import streams
from test_torch_jax_streams_suite import (BASE, T_SHORT, _chain_keys,  # noqa: F401
                                          _fb_keys_of, _hold_sheet, _record,
                                          _sheet, _triples, _write_checkpoints,
                                          drawn, models, words)


# --- the figures -------------------------------------------------------------

def _whole(seed, steps, kind="simplex"):
    return _fb_keys_of(jax.random.key(seed), steps, kind, kind, gradual=True)


def _half(seed, steps, kind="simplex"):
    return _fb_keys_of(jax.random.key(seed), steps, kind, kind)


# a "whole" sequence draws 2 lambda simplex fields: at lambda 10 as many as
# RECON_RULE's 20 reverse steps (the "half" figures run at 10 too)
WHOLE = 10

# each figure: (its call on (module, args, em, sched, root), the keys the
# JAX code draws, from `anoddpm_tpu/figures.py`'s keys at :142, :243, :266,
# :288, :309, :327, :363, at T = 20 and sample_distance 16)
FIGURES = {
    "ano": (lambda m, a, e, s, r: m.ano_outputs(a, e, s, root_dir=r, n_attempts=2,
                                                rows=1, t_distance=WHOLE),
            lambda: _whole(0, WHOLE) + _whole(97, WHOLE)),
    "sequence": (lambda m, a, e, s, r: m.denoise_sequence(a, e, s, root_dir=r),
                 lambda: _whole(0, 8)),
    "masked_comparison": (lambda m, a, e, s, r: m.masked_comparison(
        a, e, s, root_dir=r, t_distance=WHOLE, n_volumes=2),
        lambda: _half(0, WHOLE) + _half(1, WHOLE)),
    "videos": (lambda m, a, e, s, r: m.diffusion_videos(a, e, s, root_dir=r),
               lambda: _whole(0, 8) + _whole(1, 8)),
    "gauss_simplex": (lambda m, a, e, s, r: m.gauss_simplex_comparison(
        a, e, s, root_dir=r, t_distance=WHOLE),
        lambda: _half(7, WHOLE, "gauss") + _half(7, WHOLE)),
    "varying_frequency": (lambda m, a, e, s, r: m.varying_frequency(
        a, e, s, root_dir=r, end_freq=2), None),
    "varying_t": (lambda m, a, e, s, r: m.gauss_varying_t(a, e, s, root_dir=r),
                  lambda: _half(T_SHORT, T_SHORT, "gauss") * 3),
}


def _figure_records(monkeypatch, name, mod, into):
    _record(monkeypatch, mod.vz, "save_grid_png", into, _sheet)
    _record(monkeypatch, mod.vz, "save_video", into,
            lambda path, frames, **kw: (os.path.basename(path), np.stack(frames)))


@pytest.mark.parametrize("figure", sorted(FIGURES))
def test_figures_match_jax(figure, models, drawn, monkeypatch, tmp_path):
    call, keys = FIGURES[figure]
    jax_in, port_in = _triples(models)
    sheets = {"jax": [], "port": []}
    for name, mod, (args, em, sched) in (("jax", jfigures, jax_in),
                                         ("port", tfigures, port_in)):
        mod_vz = mod.vz
        _figure_records(monkeypatch, name, mod, sheets[name])
        if figure == "varying_frequency":   # its grid is written by figures
            assert mod_vz is mod.vz
        call(mod, args, em, sched, str(tmp_path / name))
    if keys is None:                       # detection_A_fixedT at lambda 20
        key, want = jax.random.key(4), []
        for _ in range(2):
            key, kf, kr = jax.random.split(key, 3)
            want += [words(kf)] + _chain_keys(kr, T_SHORT)
    else:
        want = keys()
    assert drawn == want
    assert [n for n, _ in sheets["port"]] == [n for n, _ in sheets["jax"]]
    for (_, w), (_, g) in zip(sheets["jax"], sheets["port"]):
        _hold_sheet(np.asarray(w), np.asarray(g))


def test_test_set_and_ce_figures_match_jax(models, drawn, monkeypatch, tmp_path):
    """`test_set_outputs` of two checkpoints (simplex, gauss) on the
    healthy test set, keys key(attempt * 31 + row) per model; then
    `ce_outputs` training the CE 2 steps (flax's init of key(0), masks on
    key(1) split once a step)."""
    import warnings
    warnings.simplefilter("ignore")
    _write_checkpoints(tmp_path, models, {"s": "simplex", "g": "gauss"})
    sheets = {"jax": [], "port": []}
    ce_args = defaultdict_from_json({**BASE, "arg_num": "ce"})
    for name, mod in (("jax", jfigures), ("port", tfigures)):
        _figure_records(monkeypatch, name, mod, sheets[name])
        kw = {"device": "cpu"} if name == "port" else {}
        mod.test_set_outputs("s", "g", root_dir=str(tmp_path), n_attempts=1,
                             t_distance=WHOLE, **kw)
        args = ce_args if name == "jax" else defaultdict_from_json(
            {**ce_args, "rng": "jax"})
        mod.ce_outputs(args, root_dir=str(tmp_path), n_attempts=1, rows=1,
                       ce_train_steps=2, **kw)
    want = (_whole(0, WHOLE) + _whole(1, WHOLE)
            + _whole(0, WHOLE, "gauss") + _whole(1, WHOLE, "gauss"))
    key = jax.random.key(1)
    for _ in range(2):
        key, sub = jax.random.split(key)
        want += [words(k) for k in jax.random.split(sub)]
    assert drawn == want
    assert [n for n, _ in sheets["port"]] == [n for n, _ in sheets["jax"]]
    (_, w_set), (_, g_set) = sheets["jax"][0], sheets["port"][0]
    _hold_sheet(w_set, g_set)
    # the CE sheet after 2 steps of optax's Adam against torch's
    (_, w_ce), (_, g_ce) = sheets["jax"][1], sheets["port"][1]
    _hold_sheet(w_ce, g_ce)


# --- args_dptest: dropout, loss_weight and simplex_randParam ----------------

def _dptest_args():
    from anoddpm_torch.config import load_args
    args = load_args("_dptest")
    # its widths, T, noise, loss and 2 substeps; a batch of 4 and one
    # dispatch an epoch (the JAX trainer's compile is most of the time)
    args.update(arg_num="tdp", skip_test_eval=True, checkpoint_every=1000,
                Batch_Size=4, iters_per_epoch=2)
    return args


def _dptest_draws(args):
    """(t, table row, seeds) of every step of the JAX trainer on args_dptest,
    from its code (`anoddpm_tpu/train.py`, `training.py`, `diffusion.py`,
    `ops/noise.py`): the loop key split once per substep of a dispatch,
    `fold_in(step)` split in three, t = choice(t_key, T, p = prop-t), the
    noise key split into the row's key and the seeds' key; the loop key
    split after epoch 0's VLB sweep."""
    b, T = int(args["Batch_Size"]), int(args["T"])
    w = jnp.arange(T, 0, -1).astype(jnp.float32)
    p = w / jnp.sum(w)
    key, _ = jax.random.split(jax.random.key(int(args["seed"])))
    draws, step = [], 0
    for epoch in range(int(args["EPOCHS"]) + 1):
        for _ in range(int(args["iters_per_epoch"]) // 2):
            k = key
            for _ in range(2):
                k, sub = jax.random.split(k)
                t_key, noise_key, _ = jax.random.split(
                    jax.random.fold_in(sub, step), 3)
                kp, ks = jax.random.split(noise_key)
                draws.append((
                    np.asarray(jax.random.choice(t_key, T, (b,), p=p)).tolist(),
                    int(jax.random.randint(kp, (), 0, 23)),
                    np.asarray(jsx.seeds_from_key(ks, b)).astype(np.int64).tolist()))
                step += 1
        if epoch == 0:
            key, _ = jax.random.split(key)
    return draws


def _epoch0(root, stdout, token):
    with open(f"{root}/metrics/args{token}-train.jsonl") as f:
        loss = json.loads(f.readline())["loss"]
    line = next(l for l in stdout.splitlines() if "total VLB" in l)
    return loss, float(line.split("total VLB: ")[1].split()[0])


def test_args_dptest_trains_as_the_jax_trainer(tmp_path, monkeypatch):
    """args_dptest (dropout .1, prop-t, simplex_randParam, 2 substeps, T 10;
    batch 4, 2 steps an epoch) for its 2 epochs (the loop runs epochs
    0..2): every step's
    t, table row and seeds equal the JAX trainer's; the epoch-0 loss (the
    mean of its 4 steps, each through flax's dropout masks) and the VLB
    within 1e-4 relative, as test_train_draws_and_matches_the_jax_trainer
    holds them."""
    from anoddpm_tpu import train as jtrain
    from anoddpm_torch import train as ttrain
    args = _dptest_args()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        jtrain.train(defaultdict_from_json(dict(args)), root_dir=str(tmp_path / "jax"))
    want_loss, want_vlb = _epoch0(tmp_path / "jax", out.getvalue(), "tdp")
    drawn = []
    for name in ("choice", "randint", "seeds"):
        draw = getattr(streams._JaxView, name)

        def record(view, *a, _draw=draw, _name=name):
            got = _draw(view, *a)
            if _name == "choice":
                drawn.append([got.tolist()])
            else:
                drawn[-1].append(got.tolist())
            return got
        monkeypatch.setattr(streams._JaxView, name, record)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        state = ttrain.train(defaultdict_from_json({**args, "rng": "jax"}),
                             root_dir=str(tmp_path / "port"), device="cpu")
    assert state.step == 6
    assert [tuple(d) for d in drawn] == _dptest_draws(args)
    got_loss, got_vlb = _epoch0(tmp_path / "port", out.getvalue(), "tdp")
    assert got_loss == pytest.approx(want_loss, rel=1e-4)
    assert got_vlb == pytest.approx(want_vlb, rel=1e-4)
