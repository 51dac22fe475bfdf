"""The port under `rng: "jax"` on every path beyond training and the
headline metrics, against the JAX package on the same keys.

- `jax_random.bernoulli`, `choice` (with p) and `permutation`, bit for bit
  against `jax.random`; the four noise kinds that draw more than seeds and
  normals (simplex_randParam, random, simplex_2d, the table path): their
  draws bit for bit (the table row, the seeds, the coin, the
  permutations) and their fields within the simplex rule of
  `tests/test_torch_simplex.py` (a floor() flips at a lattice-cell
  boundary on at most 0.3% of pixels); the dropout mask of every ResBlock
  of the UNet bit for bit against flax's `nn.Dropout` under the JAX train
  step's dropout key.
- The detection suite and the context encoder: each entry point against
  its JAX function at 32^2 (T 100 where a lambda grid of {50, ...} needs
  it, else 20), on the flax init of one seed perturbed as
  `torch_parity.flax_and_port` perturbs it: the key of every draw equals
  the one the JAX code splits off for it (derived here from its code
  with `jax.random`), and the reconstructions stand against JAX's by the
  `RECON_RULE` of `tests/test_torch_jax_streams.py`; the CE's init
  against flax's.  The figures and args_dptest's training are in
  `tests/test_torch_jax_streams_figures.py`.
- The dense sweep's paired verdict on synthetic curves, one test per
  verdict.
"""
import json
import os

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anoddpm_tpu import detect as jdetect
from anoddpm_tpu.config import defaultdict_from_json
from anoddpm_tpu.ops import noise as jnoise
from anoddpm_tpu.ops import simplex as jsx
from anoddpm_tpu.schedule import get_beta_schedule, make_schedule
from anoddpm_tpu.training import EvalModel
from anoddpm_torch import detect as tdetect
from anoddpm_torch import schedule as ts
from anoddpm_torch import streams
from anoddpm_torch.campaigns import dense_sweep
from anoddpm_torch.compat import jax_random as jr
from anoddpm_torch.compat.flax_init import dropout_keys
from anoddpm_torch.ops import noise as tnoise
from test_torch_jax_streams import RECON_RULE
from torch_parity import CONFIGS, flax_and_port, nchw


def words(k):
    return tuple(int(v) for v in np.asarray(jax.random.key_data(k)))


# --- the draws ---------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 + 5])
def test_bernoulli_choice_permutation_are_jax_bit_for_bit(seed):
    jk, k = jax.random.key(seed), jr.key(seed)
    for p, shape in ((0.5, ()), (0.9, (3, 5, 7, 2)), (0.1, (70000,))):
        np.testing.assert_array_equal(jr.bernoulli(k, p, shape).numpy(),
                                      np.asarray(jax.random.bernoulli(jk, p, shape)))
    for n in (1, 10, 256, 70000):      # 70,000 takes two sorting rounds
        np.testing.assert_array_equal(jr.permutation(k, n).numpy(),
                                      np.asarray(jax.random.permutation(jk, n)))
    rng = np.random.default_rng(seed % 97)
    for w in (np.arange(1000, 0, -1), np.ones(10), rng.uniform(size=4097)):
        # the JAX package's table and p (diffusion.py:458-465), and a cumsum
        # over more than 16 x 16 entries (two levels of XLA's block scan)
        w = jnp.asarray(w, jnp.float32)
        p = w / jnp.sum(w)
        want = jax.random.choice(jk, w.shape[0], (64,), p=p)
        got = jr.choice(k, torch.from_numpy(np.array(p)), (64,))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_stream_views_of_a_generator_draw_as_before():
    """A torch.Generator passes through the new view methods as itself:
    the coin, the table path's permutations and the weighted t draw what
    the code before them drew."""
    g = lambda: torch.Generator().manual_seed(3)
    assert bool(streams.of(g()).bernoulli(0.5, ())) == bool(
        torch.rand((), generator=g()) < 0.5)
    perm = streams.of(g()).permutation(3, 256)
    np.testing.assert_array_equal(
        perm.numpy(), torch.rand((3, 256), generator=g()).argsort(dim=1).numpy())
    p = torch.arange(10, 0, -1, dtype=torch.float32) / 55
    np.testing.assert_array_equal(
        streams.of(g()).choice(p, 16).numpy(),
        torch.multinomial(p, 16, replacement=True, generator=g()).numpy())
    assert streams.of(g()).fold_in_static(("a", 1)).initial_seed() == 3


SHAPE = (2, 32, 32, 1)                    # NHWC
T_FIELDS = np.array([3, 7], np.int32)


def _fields(kind, jk, k, **kw):
    """(JAX's NHWC field, the port's NHWC field) of a noise kind.  The
    table path's JAX field is `fractal3_fixed_t` on each field's
    permutation run eagerly, as tests/test_torch_noise_variants.py holds
    it: on the CPU XLA's jitted vmap of it differs from its own eager form
    on ~2% of the pixels (by up to 1.85)."""
    if kw.get("table"):
        perms, gids = jax.vmap(jsx.perm_tables_from_key)(jax.random.split(jk, 2))
        want = np.stack([np.asarray(jsx.fractal3_fixed_t(
            perms[i], gids[i], SHAPE[1:3], float(T_FIELDS[i])))
            for i in range(2)])[..., None]
    else:
        want = np.asarray(jnoise.make_noise_sampler(kind, **kw)(
            jk, SHAPE, jnp.asarray(T_FIELDS)))
    got = tnoise.make_noise_sampler(kind, **kw)(
        (SHAPE[0], SHAPE[3], SHAPE[1], SHAPE[2]),
        torch.from_numpy(T_FIELDS.astype(np.int64)), k)
    return want, got.numpy().transpose(0, 2, 3, 1)


def _close_fields(want, got):
    d = np.abs(got - want)
    assert (d <= 1e-5).mean() >= 0.997 and d.max() < 1.0, (
        d.max(), (d <= 1e-5).mean())


@pytest.mark.parametrize("seed", [1, 4])
@pytest.mark.parametrize("kind, kw", [
    ("simplex_randParam", {}), ("random", {}), ("simplex_2d", {}),
    ("simplex", {"table": True})], ids=["randParam", "random", "2d", "table"])
def test_noise_kinds_draw_the_jax_keys(kind, kw, seed, monkeypatch):
    jk, k = jax.random.key(seed), jr.key(seed)
    drawn = []
    for name in ("randint", "seeds", "bernoulli", "permutation", "normal"):
        draw = getattr(streams._JaxView, name)

        def record(view, *a, _draw=draw, _name=name):
            out = _draw(view, *a)
            drawn.append((_name, view.key.words, out.numpy().tolist()))
            return out
        monkeypatch.setattr(streams._JaxView, name, record)
    want, got = _fields(kind, jk, k, **kw)
    if kind == "simplex_randParam":
        kp, ks = jax.random.split(jk)
        index = int(jax.random.randint(kp, (), 0, len(jnoise.RAND_PARAM_TABLE)))
        seeds = np.asarray(jsx.seeds_from_key(ks, 2)).astype(np.int64).tolist()
        assert drawn == [("randint", words(kp), index),
                         ("seeds", words(ks), seeds)]
    elif kind == "random":
        kf, kn = jax.random.split(jk)
        coin = bool(jax.random.bernoulli(kf))
        assert drawn[0] == ("bernoulli", words(kf), coin)
        assert [d[:2] for d in drawn[1:]] == [("normal", words(kn)),
                                              ("seeds", words(kn))]
    elif kind == "simplex_2d":
        assert drawn == [("seeds", words(jk), np.asarray(
            jsx.seeds_from_key(jk, 2)).astype(np.int64).tolist())]
    else:
        perms = [np.asarray(jsx.perm_tables_from_key(s)[0]).tolist()
                 for s in jax.random.split(jk, 2)]
        assert drawn == [("permutation", words(jk), perms)]
    if kind == "random" and coin:
        # the Gaussian: within 128 ulps (test_torch_jax_random.py)
        assert np.abs(got - want).max() <= 128 * np.spacing(np.abs(want)).max()
    else:
        _close_fields(want, got)


def test_dropout_masks_are_flax_bit_for_bit(monkeypatch):
    """Every ResBlock's mask in a train-mode forward of the UNet (dropout
    .3) against flax's `nn.Dropout` under rngs={"dropout": key}: the keys
    equal flax's make_rng for each module path, the zeros fall where flax's
    do, and the output is flax's within fp32 rounding."""
    cfg = dict(CONFIGS["s2d1"], dropout=0.3)
    fmodel, params, port = flax_and_port(cfg, seed=2)
    x = np.random.default_rng(0).normal(size=(2, 32, 32, 1)).astype(np.float32)
    t = np.array([3, 9], np.int32)
    drop_key = jax.random.split(jax.random.fold_in(jax.random.key(5), 2), 3)[2]
    flax_sites = []

    def intercept(next_fun, args, kwargs, context):
        out = next_fun(*args, **kwargs)
        if isinstance(context.module, fnn.Dropout):
            flax_sites.append((context.module.scope.path,
                               np.asarray(out).transpose(0, 3, 1, 2)))
        return out
    with fnn.intercept_methods(intercept):
        want = np.asarray(fmodel.apply(params, jnp.asarray(x), jnp.asarray(t),
                                       rngs={"dropout": drop_key},
                                       deterministic=False))
    port_sites = []
    dropout = streams._JaxView.dropout

    def record(view, h, rate):
        out = dropout(view, h, rate)
        port_sites.append((view.key.words, out.detach().numpy()))
        return out
    monkeypatch.setattr(streams._JaxView, "dropout", record)
    key = jr.key(5).fold_in(2).split(3)[2]
    assert key.words == words(drop_key)
    port.train()
    port.dropout_streams = dropout_keys(port, key)
    with torch.no_grad():
        got = port(nchw(x), torch.from_numpy(t.astype(np.int64))).numpy()
    assert len(port_sites) == len(flax_sites) > 10
    for (path, w), (k, g) in zip(flax_sites, port_sites):
        want_key = jr.fold_in_static(key, (*path, 1))
        assert k == want_key.words, path
        np.testing.assert_array_equal(g == 0, w == 0, err_msg=str(path))
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got.transpose(0, 2, 3, 1), want, rtol=1e-4,
                               atol=1e-4)


# --- the detection suite -----------------------------------------------------

T_SHORT = 20
# one level of the UNet at 32^2 through a space-to-depth of 2 (a 16^2 grid):
# seven ResBlocks and the middle attention, to keep the JAX compiles short
SMALL = dict(img_size=32, base_channels=32, channel_mults=(1,),
             attention_resolutions="16", space_to_depth=2)
BASE = {"img_size": [32, 32], "dataset": "synthetic", "noise_fn": "simplex",
        "anomalous_volumes": 2, "sample_distance": 16, "T": T_SHORT,
        "beta_schedule": "cosine", "base_channels": 32, "channel_mults": "1",
        "attention_resolutions": "16", "space_to_depth": 2,
        "compute_dtype": "float32", "Batch_Size": 2}


@pytest.fixture(scope="module")
def models():
    """The flax UNet SMALL from the flax init of seed 1, perturbed, and the
    port's twin."""
    fmodel, params, port = flax_and_port(SMALL, seed=1)
    return EvalModel(fmodel, params), port


def _triples(models, t_len=T_SHORT, **over):
    jem, port = models
    args = {**BASE, "T": t_len, "arg_num": "tsuite", **over}
    return ((defaultdict_from_json(args), jem,
             make_schedule(get_beta_schedule(t_len, "cosine"))),
            (defaultdict_from_json({**args, "rng": "jax"}), port,
             ts.make_schedule(ts.get_beta_schedule(t_len, "cosine"))))


@pytest.fixture
def drawn(monkeypatch):
    """The key of every draw the port makes, in order."""
    keys = []
    for name in ("seeds", "normal", "randint"):
        draw = getattr(streams._JaxView, name)

        def record(view, *a, _draw=draw):
            keys.append(view.key.words)
            return _draw(view, *a)
        monkeypatch.setattr(streams._JaxView, name, record)
    return keys


def _chain_keys(key, steps):
    """The keys of a chain of `steps` draws from `key`, each step
    splitting off one (`denoise_chain`, `diffuse_gradual_chain`)."""
    out = []
    for _ in range(steps):
        key, sub = jax.random.split(key)
        out.append(words(sub))
    return out


def _fb_keys(key, steps, gradual=False):
    """The keys of `forward_backward(key)` at lambda = steps: the q-jump's
    (or the gradual chain's), then each reverse step's."""
    fwd, rev = jax.random.split(key)
    return ((_chain_keys(fwd, steps) if gradual else [words(fwd)])
            + _chain_keys(rev, steps))


def _hold(want, got, rule="simplex"):
    share, worst = RECON_RULE[rule]
    want, got = np.asarray(want, np.float64), np.asarray(got, np.float64)
    assert want.shape == got.shape
    d = np.abs(got - want)
    assert (d <= 1e-4).mean() >= share and d.max() <= worst, (
        d.max(), (d <= 1e-4).mean())


def _record(monkeypatch, module, attr, into, pick=lambda *a: a):
    """Record `pick(*args)` of every call of module.attr, then call it."""
    fn = getattr(module, attr)

    def wrapped(*a, **kw):
        into.append(pick(*a, **kw))
        return fn(*a, **kw)
    monkeypatch.setattr(module, attr, wrapped)


def test_graph_data_matches_jax(models, drawn, monkeypatch, tmp_path):
    """Two volumes, lambdas 0, 5, 12, 19 in chunks of 3 (the second padded
    with its first lambda): key(11) split once per chunk, each chunk a
    masked chain of 19 steps; the per-volume CSVs and the pooled rows
    within RECON_RULE."""
    jax_in, port_in = _triples(models)
    recons = {"jax": [], "port": []}
    rows = {}
    for name, mod, triple in (("jax", jdetect, jax_in), ("port", tdetect, port_in)):
        _record(monkeypatch, mod.M, "batched_anomaly_metrics", recons[name],
                lambda images, recon, masks: np.asarray(recon))
        kw = {"device": "cpu"} if name == "port" else {}
        rows[name] = mod.graph_data(args=triple, root_dir=str(tmp_path / name),
                                    lambdas=[0, 5, 12, 19], max_volumes=2,
                                    lambda_batch=3, **kw)
    key, want = jax.random.key(11), []
    for _ in range(2 * 2):
        key, sub = jax.random.split(key)
        want += _fb_keys(sub, 19)
    assert drawn == want
    assert len(recons["port"]) == len(recons["jax"]) == 4
    for w, g in zip(recons["jax"], recons["port"]):
        _hold(w, g)
    for vol in ("synthetic-anomalous-00000", "synthetic-anomalous-00001"):
        read = lambda n: np.loadtxt(tmp_path / n / "metrics" / "ARGS=tsuite" /
                                    f"{vol}.csv", delimiter=",", skiprows=1)
        _hold(read("jax"), read("port"))
    _hold([[r[k] for k in ("dice", "ssim", "iou", "auc")] for r in rows["jax"]],
          [[r[k] for k in ("dice", "ssim", "iou", "auc")] for r in rows["port"]])


T_LONG = 100           # the sweeps' lambda grid {50, ...} below 0.6 T


def _noise_keys(kind, key):
    """The keys the port's sampler of `kind` records for one call on
    `key`: randParam splits off its table row's key and its seeds' key."""
    if kind == "simplex_randParam":
        return [words(k) for k in jax.random.split(key)]
    return [words(key)]


def _fb_keys_of(key, steps, fwd_kind="simplex", rev_kind="gauss",
                gradual=False):
    """`_fb_keys` with the keys each noise kind records."""
    fwd, rev = jax.random.split(key)
    out = []
    for k in ([*_chain_keys_raw(fwd, steps)] if gradual else [fwd]):
        out += _noise_keys(fwd_kind, k)
    for k in _chain_keys_raw(rev, steps):
        out += _noise_keys(rev_kind, k)
    return out


def _chain_keys_raw(key, steps):
    for _ in range(steps):
        key, sub = jax.random.split(key)
        yield sub


def _chains(key, n, steps, **kw):
    """(the key after, the keys of n `forward_backward` chains, each on a
    key split off `key`), as methods A and B and the ROC split it."""
    out = []
    for _ in range(n):
        key, sub = jax.random.split(key)
        out += _fb_keys_of(sub, steps, **kw)
    return key, out


def _slice_inputs():
    from anoddpm_tpu.data.datasets import anomalous_dataset_from_args
    sample = anomalous_dataset_from_args(".", defaultdict_from_json(BASE))[0]
    return np.asarray(sample["image"][1:2]), np.asarray(sample["mask"][1:2])


def _sheet(path, panels, row_size=None):
    return os.path.basename(path), np.asarray(panels)


def _hold_sheet(want, got):
    """A sheet's panels: a thresholded map (every value +-1) equal on 99%
    of its pixels (a score within the rule of the threshold may flip it),
    every other panel by RECON_RULE."""
    assert want.shape == got.shape
    for w, g in zip(want, got):
        if np.isin(w, (-1.0, 1.0)).all():
            assert (w == g).mean() >= 0.99
        else:
            _hold(w, g)


@pytest.mark.parametrize("method", ["A", "B", "A_fixedT"])
def test_detection_methods_match_jax(method, models, drawn, monkeypatch,
                                     tmp_path):
    """Method A (7 frequencies x lambda 50), B ("octave", lambda 50) and
    A_fixedT (frequencies 2^1, 2^2 at lambda 50) from their default keys
    key(2), key(3), key(4), one reconstruction each."""
    x, mask = _slice_inputs()
    jax_in, port_in = _triples(models, T_LONG)
    out, sheets = {}, {"jax": [], "port": []}
    for name, mod, (args, em, sched) in (("jax", jdetect, jax_in),
                                         ("port", tdetect, port_in)):
        _record(monkeypatch, mod.vz, "save_grid_png", sheets[name], _sheet)
        _record(monkeypatch, mod.vz, "heatmap_figure", sheets[name],
                lambda real, recon, m, path: (os.path.basename(path), recon))
        root = str(tmp_path / name)
        if method == "A":
            mod.detection_A(args, em, sched, x, mask, "f", root_dir=root,
                            total_avg=1)
        elif method == "B":
            out[name] = mod.detection_B(args, em, sched, x, mask, "f",
                                        root_dir=root, total_avg=1)
        else:
            out[name] = mod.detection_A_fixedT(args, em, sched, x, mask,
                                               end_freq=2, t_distance=50)
    if method == "A":
        _, want = _chains(jax.random.key(2), 7, 50)
    elif method == "B":
        _, want = _chains(jax.random.key(3), 1, 50)
        assert abs(out["port"][0] - out["jax"][0]) <= 1e-2
    else:
        key, want = jax.random.key(4), []
        for _ in range(2):
            key, kf, kr = jax.random.split(key, 3)
            want += [words(kf)] + _chain_keys(kr, 50)
        _hold_sheet(out["jax"], out["port"])
    assert drawn == want
    assert [n for n, _ in sheets["port"]] == [n for n, _ in sheets["jax"]]
    for (_, w), (_, g) in zip(sheets["jax"], sheets["port"]):
        _hold_sheet(np.asarray(w), np.asarray(g))


def test_anomalous_validation_matches_jax(models, drawn, monkeypatch, tmp_path):
    """One slice of a simplex_randParam config: key(5) split in five per
    slice, t = randint(k_t) in [2, 12) (sample_distance 20), the "whole"
    sequence on k1, method A on k3 then method B on k2."""
    jax_in, port_in = _triples(models, T_LONG, noise_fn="simplex_randParam",
                               sample_distance=20)
    sheets = {"jax": [], "port": []}
    dice = {}
    for name, mod, triple in (("jax", jdetect, jax_in), ("port", tdetect, port_in)):
        _record(monkeypatch, mod.vz, "save_grid_png", sheets[name], _sheet)
        _record(monkeypatch, mod.vz, "heatmap_figure", sheets[name],
                lambda real, recon, m, path: (os.path.basename(path), recon))
        monkeypatch.setattr(mod.vz, "save_video", lambda *a, **k: None)
        kw = {"device": "cpu"} if name == "port" else {}
        dice[name] = mod.anomalous_validation(
            triple, root_dir=str(tmp_path / name), max_volumes=1, max_slices=1,
            detection_avg=1, **kw)
    key = jax.random.key(5)
    key, k_t, k1, k2, k3 = jax.random.split(key, 5)
    t = int(jax.random.randint(k_t, (), 2, 12))
    want = [words(k_t)] + _fb_keys_of(k1, t, "simplex_randParam",
                                      "simplex_randParam", gradual=True)
    want += _chains(k3, 7, 50)[1] + _chains(k2, 1, 50)[1]
    assert drawn == want
    assert [n for n, _ in sheets["port"]] == [n for n, _ in sheets["jax"]]
    assert sheets["port"][0][0] == f"t={t}.png"
    for (_, w), (_, g) in zip(sheets["jax"], sheets["port"]):
        _hold_sheet(np.asarray(w), np.asarray(g))
    assert np.abs(np.subtract(dice["port"], dice["jax"])).max() <= 1e-2


def _write_checkpoints(root, models, tokens):
    """JAX checkpoints of the flax model under `root` for each token:
    {token: noise kind}; their args carry rng "jax" for the port (the JAX
    package warns of the key and ignores it)."""
    import optax
    from anoddpm_tpu import checkpoint as jckpt
    jem, _ = models
    for token, kind in tokens.items():
        args = defaultdict_from_json({**BASE, "arg_num": token, "noise_fn": kind,
                                      "rng": "jax"})
        jckpt.save_checkpoint(str(root), args, 0, jem.params, jem.params,
                              optax.adamw(1e-4).init(jem.params), final=True)


def _ce_config(root):
    os.makedirs(root / "configs", exist_ok=True)
    with open(root / "configs" / "argsce.json", "w") as f:
        json.dump({**BASE, "arg_num": "ce", "rng": "jax"}, f)


def test_roc_data_with_the_context_encoder_matches_jax(models, drawn,
                                                       monkeypatch, tmp_path):
    """Two volumes at lambda 10: key(13) split once per volume; then the
    context encoder from flax's init of key(0), 3 steps on key(1) split
    once a step, each step's box rows and columns drawn from a split of
    that step's key.  The diffusion scores within RECON_RULE (squares of
    reconstructions within it), the CE's AUC within 1e-3 (optax's Adam
    against torch's over 3 steps)."""
    import warnings
    warnings.simplefilter("ignore")
    _write_checkpoints(tmp_path, models, {"s": "simplex"})
    _ce_config(tmp_path)
    scores = {"jax": [], "port": []}
    curves = {}
    for name, mod in (("jax", jdetect), ("port", tdetect)):
        _record(monkeypatch, mod.M, "roc_curve", scores[name],
                lambda labels, s: np.asarray(s))
        kw = {"device": "cpu"} if name == "port" else {}
        curves[name] = mod.roc_data(["s"], root_dir=str(tmp_path), t_distance=10,
                                    max_volumes=2, ce_token="ce",
                                    ce_train_steps=3, **kw)
    _, want = _chains(jax.random.key(13), 2, 10, rev_kind="simplex")
    key = jax.random.key(1)
    for _ in range(3):
        key, sub = jax.random.split(key)
        want += [words(k) for k in jax.random.split(sub)]
    assert drawn == want
    _hold(scores["jax"][0], scores["port"][0])
    from anoddpm_torch import metrics as tm
    for label in ("argss", "context-encoder"):
        auc = [tm.auc(*curves[n][label]) for n in ("jax", "port")]
        assert abs(auc[0] - auc[1]) <= (1e-3 if label != "argss" else 1e-2), (
            label, auc)


def test_context_encoder_init_is_flax(monkeypatch):
    """`context_encoder_from_seed` under rng "jax" against the JAX
    package's `model.init(key(seed), ...)`: zeros and ones exact, each
    kernel within 8 ulps of its lecun_normal scale (the bound of
    `tests/test_torch_jax_streams.py`)."""
    from anoddpm_tpu.models.context_encoder import ContextEncoder as FlaxCE
    from anoddpm_torch.compat.flax_params import context_encoder_state_dict_from_flax
    from anoddpm_torch.models.context_encoder import context_encoder_from_seed
    params = FlaxCE(base_channels=8).init(
        jax.random.key(3), jnp.zeros((2, 32, 32, 1)), jnp.zeros((2, 32, 32, 1)))
    want = {k: v.numpy() for k, v in context_encoder_state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, params)).items()}
    got = context_encoder_from_seed({"rng": "jax"}, 3, 1, 8).state_dict()
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k].numpy()
        if not w.any() or (w == 1).all():
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            s = np.sqrt(1.0 / np.prod(w.shape[1:])) / 0.87962566103423978
            assert np.abs(g.astype(np.float64) - w).max() <= 8 * 2 ** -23 * s, k
    # the torch stream's init stays torch's
    torch_init = context_encoder_from_seed({}, 3, 1, 8).state_dict()
    assert not torch.equal(torch_init["convs.0.weight"], got["convs.0.weight"])


# --- the dense sweep paired: the verdict on synthetic curves ----------------

LAMBDAS = list(range(0, 1000, 25))


def _curves(seed=0):
    """JAX-like pooled curves over the 40 lambdas (a Dice hump peaking at
    325, an AUC one at 75) and 22 volumes' Dice around the pooled one."""
    lam = np.asarray(LAMBDAS, np.float64)
    rng = np.random.default_rng(seed)
    dice = 0.28 * np.exp(-((lam - 325) / 200) ** 2) + rng.normal(0, .01, 40)
    auc = 0.6 + 0.2 * np.exp(-((lam - 75) / 150) ** 2) + rng.normal(0, .01, 40)
    dice[0], dice[13], auc[3] = 0.0, 0.32, 0.83
    vols = {f"v{i}": np.clip(dice + rng.normal(0, .05, 40), 0, 1) for i in range(22)}
    for v in vols.values():
        v[0] = 0.0
    return {"dice": dice, "auc": auc}, vols


@pytest.mark.parametrize("case, verdict", [
    ("twins", "closed: the curve pairs"),
    ("shifted", "a fault in the port"),
    ("apart", "open: the trajectories part")])
def test_dense_sweep_paired_verdicts(case, verdict, tmp_path):
    """`dense_sweep.paired_verdict` by the rule of PERF.md section 2: twins
    within .002 close it; Dice ~0.05 higher on every volume at lambda
    400..650 is a fault there (the pooled peak moves off 325); noise of
    mean 0 on every lambda (another draw, as the torch streams are) parts
    the curves with no lambda where the volumes' Dice moves one way.
    `paired_main` reads the files and writes the result beside the
    torch-stream curve."""
    jax_pooled, jax_vols = _curves(0)
    if case == "twins":
        rng = np.random.default_rng(1)
        port = {m: v + rng.uniform(-.002, .002, 40) for m, v in jax_pooled.items()}
        port_vols = {k: v + rng.uniform(-.002, .002, 40) * (v > 0)
                     for k, v in jax_vols.items()}
    elif case == "shifted":
        rng = np.random.default_rng(2)
        port_vols = {k: v.copy() for k, v in jax_vols.items()}
        for v in port_vols.values():
            v[16:27] += 0.05 + rng.normal(0, .01, 11)
        port = {"dice": jax_pooled["dice"].copy(), "auc": jax_pooled["auc"]}
        port["dice"][16:27] += 0.1
    else:
        # another draw of the same volumes: each lambda's Dice moved by
        # noise of mean 0
        rng = np.random.default_rng(7)
        port = {m: v + rng.normal(0, .03, 40) for m, v in jax_pooled.items()}
        port_vols = {k: v + rng.normal(0, .05, 40) * (v > 0)
                     for k, v in jax_vols.items()}
    out = dense_sweep.paired_verdict(LAMBDAS, port, jax_pooled, port_vols,
                                     jax_vols)
    assert out["verdict"].startswith(verdict), out["verdict"]
    assert out["curves"]["dice"]["jax_peak_lambda"] == 325
    if case == "shifted":
        assert "Dice at lambda 400..650" in out["verdict"]
        assert out["holds"]["dice"]["peak"] is False
    if case == "apart":
        assert not out["rejected"] and len(out["dice_tests"]) == 39

    # paired_main on files laid out as the card run and the JAX package
    # leave them
    def write(pooled, vols, pooled_path, vol_dir):
        os.makedirs(vol_dir, exist_ok=True)
        os.makedirs(os.path.dirname(pooled_path), exist_ok=True)
        with open(pooled_path, "w") as f:
            f.write("t,dice,ssim,iou,auc\n")
            for j, t in enumerate(LAMBDAS):
                f.write(f"{t},{float(pooled['dice'][j])!r},0.5,0.1,"
                        f"{float(pooled['auc'][j])!r}\n")
        for name, v in vols.items():
            with open(os.path.join(vol_dir, f"{name}.csv"), "w") as f:
                f.write("timestep,Dice,SSIM,IOU,Precision,Recall,FPR\n")
                for j, t in enumerate(LAMBDAS):
                    f.write(f"{t:04},{v[j]:.4f},0,0,0,0,0\n")
    root = tmp_path
    write(jax_pooled, jax_vols, root / "metrics" / "args256syn64s2d-lambda.csv",
          root / "metrics" / "ARGS=256syn64s2d")
    port_dir = root / "results" / "torch_dense_sweep_jaxrng"
    write(port, port_vols, port_dir / "args256syn64s2d_jaxrng-lambda.csv",
          port_dir / "ARGS=256syn64s2d_jaxrng")
    write(*_curves(3), root / "results" / "torch_dense_sweep" /
          "args256syn64s2d-lambda.csv", root / "results" / "unused")
    got = dense_sweep.main(["--paired", "--root", str(root)])
    assert got["verdict"].startswith(verdict)
    with open(root / "results" / "torch_dense_sweep_jaxrng_paired.json") as f:
        assert json.load(f)["verdict"] == got["verdict"]
    assert set(got["torch_stream"]) == {"dice", "auc"}


def test_dense_sweep_trains_as_the_jax_campaign():
    """`--rng jax` trains the config as `scripts/dense_sweep_campaign.py`
    does (its seed, no train_substeps, so 1 step a dispatch as
    test_train_draws_and_matches_the_jax_trainer[1] holds the schedule;
    bf16_norm from the config; the test-set suite off) on the JAX streams
    in the JAX UNet's norm order, under its own token."""
    args = dense_sweep.sweep_args(rng="jax")
    assert (args["rng"], args["norm_impl"], args["bf16_norm"], args["seed"],
            args.get("train_substeps"), args["skip_test_eval"]) == (
        "jax", "flax", True, 0, None, True)
    assert args["arg_num"] == "256syn64s2d_jaxrng" and args["EPOCHS"] == 600
    assert "rng" not in dense_sweep.sweep_args()
