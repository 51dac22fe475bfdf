"""The port's training path against the JAX package: one train step (loss,
grad norm, gradients, update, EMA, Adam's moments), a resume from a
checkpoint the JAX trainer wrote, the clip + AdamW chain against optax,
and the `train` entry point on the CPU through a checkpoint and a resume.

t is JAX's own draw (fold_in(key, step), split, randint), handed to the
port; the noise comes from one numpy bank on both sides."""
import json
import os
import threading

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from anoddpm_tpu import checkpoint as jckpt
from anoddpm_tpu import diffusion as jd
from anoddpm_tpu import metrics as jmetrics
from anoddpm_tpu import training as jtr
from anoddpm_tpu.config import defaultdict_from_json
from anoddpm_tpu.data import pipeline as jpipe
from anoddpm_tpu.data.synthetic import SyntheticMRIDataset as JaxHealthy
from anoddpm_tpu.models.ema import ema_update as jax_ema_update
from anoddpm_tpu.schedule import get_beta_schedule, make_schedule
from anoddpm_torch import checkpoint as tckpt
from anoddpm_torch import metrics as tmetrics
from anoddpm_torch import schedule as ts
from anoddpm_torch import train as ttrain
from anoddpm_torch import training as ttr
from anoddpm_torch.compat.flax_params import (adamw_state_from_optax,
                                              unet_state_dict_from_flax)
from anoddpm_torch.data import pipeline as tpipe
from anoddpm_torch.data.datasets import dataset_from_args
from anoddpm_torch.models.ema import ema_update, init_ema
from anoddpm_torch.models.unet import UNet
from torch_parity import CONFIGS, T, bank_samplers, flax_and_port, nchw

LR = 1e-4
MAX_T = 12          # train_start: t < min(sample_distance, T) with T = 20
BATCH = 2
CFG = CONFIGS["s2d1"]


def jax_t(key, step):
    """The t that `anoddpm_tpu.training.make_train_step` draws at `step`."""
    t_key, _, _ = jax.random.split(jax.random.fold_in(key, step), 3)
    return np.asarray(jd.sample_timesteps(t_key, BATCH, MAX_T))


def torch_tree(tree):
    """A flax parameter-shaped tree as the port's {name: numpy array}."""
    return {k: v.numpy() for k, v in unet_state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, tree)).items()}


def batches(n):
    ds = JaxHealthy(img_size=(32, 32), length=2 * n)
    return [np.stack([ds[2 * i]["image"], ds[2 * i + 1]["image"]])
            for i in range(n)]


@pytest.fixture(scope="module")
def jax_side():
    """The JAX trainer on the tiny UNet: three steps from perturbed
    parameters, the gradients of the first and third, a checkpoint after
    the second."""
    fmodel, params, _ = flax_and_port(CFG)
    jsched = make_schedule(get_beta_schedule(T, "cosine"))
    jsamp, tsamp = bank_samplers((BATCH, 32, 32, 1))
    tx = jtr.make_optimizer(LR, 0.0, 1.0)
    step = jax.jit(jtr.make_train_step(fmodel, jsched, tx, jsamp, "l2",
                                       max_t=MAX_T))
    key = jax.random.key(7)
    xs = batches(3)

    def grads_at(p, x, t):
        def loss_fn(pp):
            per, _ = jd.calc_loss(lambda a, b: fmodel.apply(pp, a, b), jsched,
                                  jnp.asarray(x), jnp.asarray(t),
                                  jax.random.key(0), jsamp)
            return jnp.mean(per)
        return jax.jit(jax.grad(loss_fn))(p)

    states = [jtr.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                             ema_params=params, opt_state=tx.init(params))]
    metrics = []
    for i in range(3):
        st, m = step(states[-1], jnp.asarray(xs[i]), key)
        states.append(st)
        metrics.append(m)
    return dict(params=params, states=states, metrics=metrics, xs=xs, key=key,
                tsamp=tsamp,
                grads=[grads_at(states[i].params, xs[i], jax_t(key, i))
                       for i in (0, 2)])


def port_state(sd=None):
    model = UNet(**CFG)
    if sd is not None:
        model.load_state_dict(sd)
    return ttr.init_train_state(model, ttr.make_optimizer(model.parameters(), LR))


def port_step(state, jax_side, i):
    tsched = ts.make_schedule(ts.get_beta_schedule(T, "cosine"))
    step = ttr.make_train_step(tsched, jax_side["tsamp"], "l2", max_t=MAX_T)
    t = torch.from_numpy(jax_t(jax_side["key"], i).astype(np.int64))
    return step(state, nchw(jax_side["xs"][i]), torch.Generator(), t=t)


def params_of(module):
    return {n: p.detach().numpy().copy() for n, p in module.named_parameters()}


def assert_update_matches(got_before, got_after, want_before, want_after, grads):
    """after - before at rtol 1e-3 where |g| > 1e-3 max|g|: Adam's first
    steps move an element whose gradient is near 0 by up to lr, with a sign
    set by rounding.  Two floors: the update is read as the difference of
    two fp32 parameters, so it is known to one ulp of the parameter; and
    after the first step Adam's first moment nearly cancels where the
    gradient changed sign, so there the update's error is relative to lr,
    not to itself (1e-4 lr: the gradients' rtol carried through Adam)."""
    gmax = max(np.abs(g).max() for g in grads.values())
    for n, g in grads.items():
        keep = np.abs(g) > 1e-3 * gmax
        got = (got_after[n] - got_before[n])[keep]
        want = (want_after[n] - want_before[n])[keep]
        ulp = np.spacing(np.maximum(np.abs(want_before[n]),
                                    np.abs(want_after[n])))[keep]
        bad = np.abs(got - want) > 1e-3 * np.abs(want) + ulp + 1e-4 * LR
        assert not bad.any(), (n, got[bad][:5], want[bad][:5])


def assert_ema_matches(ema, want_tree):
    """atol 1e-7, or one fp32 ulp of the value (2^-23 relative) where that
    is larger: the norm weights are near 1, where one ulp is 1.19e-7, and
    the port's `_foreach_add_` may fuse the product into the add where JAX
    rounds it first."""
    want = torch_tree(want_tree)
    for n, p in ema.named_parameters():
        np.testing.assert_allclose(p.numpy(), want[n], atol=1e-7, rtol=2 ** -23,
                                   err_msg=n)


def test_train_step_matches_jax(jax_side):
    state = port_state(unet_state_dict_from_flax(jax_side["params"]))
    before = params_of(state.model)
    m = port_step(state, jax_side, 0)
    assert state.step == 1 and m["loss"].shape == m["grad_norm"].shape == ()
    want = jax_side["metrics"][0]
    np.testing.assert_allclose(float(m["loss"]), float(want["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(m["grad_norm"]), float(want["grad_norm"]),
                               rtol=1e-5)
    # the port's gradients are clipped in place, by optax's factor
    grads = torch_tree(jax_side["grads"][0])
    clip = max(float(want["grad_norm"]), 1.0)
    for n, p in state.model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), grads[n] / clip,
                                   atol=1e-6, rtol=1e-4, err_msg=n)
    new = jax_side["states"][1]
    assert_update_matches(before, params_of(state.model),
                          torch_tree(jax_side["params"]), torch_tree(new.params),
                          grads)
    assert_ema_matches(state.ema, new.ema_params)
    # Adam's moments, through the optax -> AdamW conversion; the atol
    # carries the gradients' (mu = 0.1 g, nu = 0.001 g^2)
    moments = adamw_state_from_optax(
        flax.serialization.to_state_dict(new.opt_state))
    got = ttr.optimizer_state(state)
    for n, entry in got.items():
        assert float(entry["step"]) == float(moments[n]["step"]) == 1.0
        np.testing.assert_allclose(entry["exp_avg"].numpy(),
                                   moments[n]["exp_avg"].numpy(),
                                   rtol=1e-4, atol=1e-7, err_msg=n)
        np.testing.assert_allclose(entry["exp_avg_sq"].numpy(),
                                   moments[n]["exp_avg_sq"].numpy(),
                                   rtol=1e-4, atol=1e-12, err_msg=n)


def test_train_steps_match_jax_at_space_to_depth_2():
    """Three train steps of the UNet on a 2 x 2 patchified grid (the
    256syn64s2d family's option) against the JAX trainer from the same
    parameters, with JAX's t and one noise bank: each step's loss and grad
    norm, the first step's gradients, and the parameters after three
    steps."""
    cfg = CONFIGS["s2d2"]
    fmodel, params, _ = flax_and_port(cfg)
    jsched = make_schedule(get_beta_schedule(T, "cosine"))
    jsamp, tsamp = bank_samplers((BATCH, 32, 32, 1))
    tx = jtr.make_optimizer(LR, 0.0, 1.0)
    jstep = jax.jit(jtr.make_train_step(fmodel, jsched, tx, jsamp, "l2",
                                        max_t=MAX_T))
    key = jax.random.key(11)
    xs = batches(3)
    jstate = jtr.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                            ema_params=params, opt_state=tx.init(params))
    model = UNet(**cfg)
    model.load_state_dict(unet_state_dict_from_flax(params))
    state = ttr.init_train_state(model, ttr.make_optimizer(model.parameters(), LR))
    step = ttr.make_train_step(ts.make_schedule(ts.get_beta_schedule(T, "cosine")),
                               tsamp, "l2", max_t=MAX_T)
    for i in range(3):
        jstate, want = jstep(jstate, jnp.asarray(xs[i]), key)
        t = torch.from_numpy(jax_t(key, i).astype(np.int64))
        got = step(state, nchw(xs[i]), torch.Generator(), t=t)
        np.testing.assert_allclose(float(got["loss"]), float(want["loss"]),
                                   rtol=1e-5, err_msg=f"step {i}")
        np.testing.assert_allclose(float(got["grad_norm"]),
                                   float(want["grad_norm"]), rtol=1e-5,
                                   err_msg=f"step {i}")
    # Adam moves elements whose gradient is near 0 by up to lr a step with
    # a rounding-set sign: parameters within 3 lr after 3 steps
    final = torch_tree(jstate.params)
    for n, p in state.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), final[n], rtol=0,
                                   atol=3 * LR + 1e-6, err_msg=n)


def test_resume_from_jax_checkpoint_matches_jax(jax_side, tmp_path):
    """JAX trains 2 steps and saves; the port restores model, EMA and AdamW
    from that checkpoint and takes step 3, which matches JAX's step 3."""
    st2, st3 = jax_side["states"][2], jax_side["states"][3]
    args = defaultdict_from_json({"arg_num": "jxr", "img_size": [32, 32]})
    jckpt.save_checkpoint(str(tmp_path), args, 2, st2.params, st2.ema_params,
                          st2.opt_state)
    state = port_state()
    assert ttrain.restore_train_state(state, str(tmp_path), args,
                                      "RESUME_RECENT") == 2
    assert float(ttr.optimizer_state(state)["stem.weight"]["step"]) == 2.0
    before = params_of(state.model)
    m = port_step(state, jax_side, 2)
    np.testing.assert_allclose(float(m["loss"]),
                               float(jax_side["metrics"][2]["loss"]), rtol=1e-5)
    assert_update_matches(before, params_of(state.model),
                          torch_tree(st2.params), torch_tree(st3.params),
                          torch_tree(jax_side["grads"][1]))
    assert_ema_matches(state.ema, st3.ema_params)


@pytest.mark.parametrize("scale,wd", [(0.01, 0.0), (50.0, 0.0), (50.0, 0.1)])
def test_optimizer_matches_optax_chain(scale, wd):
    """Three steps of clip(1.0) + AdamW on random gradients below and above
    the clip norm, with and without weight decay, against optax."""
    rng = np.random.default_rng(int(scale))
    params = {"a": rng.normal(size=(4, 5)).astype(np.float32),
              "b": rng.normal(size=(7,)).astype(np.float32)}
    tx = jtr.make_optimizer(1e-2, wd, 1.0)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    js = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    opt = ttr.make_optimizer(tp.values(), 1e-2, wd, 1.0)
    for _ in range(3):
        g = {k: (scale * rng.normal(size=v.shape)).astype(np.float32)
             for k, v in params.items()}
        upd, js = tx.update(jax.tree_util.tree_map(jnp.asarray, g), js, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k].copy())
        norm = opt.step()
        np.testing.assert_allclose(float(norm), float(optax.global_norm(g)),
                                   rtol=1e-6)
    for k, p in tp.items():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]),
                                   rtol=1e-5, atol=1e-7)


def test_ema_matches_jax():
    rng = np.random.default_rng(3)
    e = [rng.normal(size=(3, 4)).astype(np.float32) for _ in range(2)]
    p = [rng.normal(size=(3, 4)).astype(np.float32) for _ in range(2)]
    want = jax_ema_update([jnp.asarray(a) for a in e], [jnp.asarray(a) for a in p])
    got = [torch.from_numpy(a.copy()) for a in e]
    ema_update(got, [torch.from_numpy(a) for a in p])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-7, rtol=0)
    model = UNet(**CFG)
    ema = init_ema(model)
    assert not any(q.requires_grad for q in ema.parameters())
    assert all(torch.equal(a, b) for a, b in zip(ema.parameters(), model.parameters()))


def test_data_pipeline_matches_jax():
    args = defaultdict_from_json({"img_size": (32, 32), "dataset": "synthetic"})
    for train, seed in ((True, 0), (False, 1)):
        got, want = dataset_from_args(".", args, train), JaxHealthy((32, 32), seed=seed)
        for i in (0, 7):
            np.testing.assert_array_equal(got[i]["image"], want[i]["image"])
            assert got[i]["filenames"] == want[i]["filenames"]
    ds = dataset_from_args(".", args)
    it_t = tpipe.batch_iterator(ds, 3, seed=4)
    it_j = jpipe.batch_iterator(JaxHealthy((32, 32)), 3, seed=4)
    for _ in range(40):       # more than one pass: the reshuffle agrees too
        np.testing.assert_array_equal(next(it_t)["image"], next(it_j)["image"])
    fetched = next(tpipe.prefetch_to_device(tpipe.batch_iterator(ds, 3, seed=4),
                                            "cpu"))
    first = next(tpipe.batch_iterator(ds, 3, seed=4))["image"]
    assert fetched["image"].shape == (3, 1, 32, 32)
    np.testing.assert_array_equal(fetched["image"].numpy(),
                                  first.transpose(0, 3, 1, 2))
    # "mri" reads DATASETS/ under the root, as the JAX package does
    from anoddpm_tpu.data.datasets import dataset_from_args as jax_dataset
    mri = defaultdict_from_json({"img_size": (32, 32), "dataset": "mri"})
    for fn in (dataset_from_args, jax_dataset):
        with pytest.raises(FileNotFoundError, match="DATASETS"):
            fn(str(os.getcwd()), mri)


def test_psnr_equals_jax():
    rng = np.random.default_rng(5)
    real = rng.uniform(-1, 1, (2, 8, 8, 1))
    recon = real + rng.normal(0, 0.1, real.shape)
    assert tmetrics.psnr(recon, real) == jmetrics.psnr(recon, real)


def test_port_checkpoint_keeps_optimizer_state(tmp_path):
    state = port_state()
    x = torch.from_numpy(batches(1)[0].transpose(0, 3, 1, 2).copy())
    tsched = ts.make_schedule(ts.get_beta_schedule(T, "cosine"))
    ttr.make_train_step(tsched, lambda s, t, g: torch.ones(s), max_t=MAX_T)(
        state, x, torch.Generator().manual_seed(0))
    saved = ttr.optimizer_state(state)
    args = defaultdict_from_json({"arg_num": "opt", "img_size": [32, 32]})
    tckpt.save_checkpoint(str(tmp_path), args, 1, state.model.state_dict(),
                          state.ema.state_dict(), saved)
    assert tckpt.latest_checkpoint_path(str(tmp_path), "opt").endswith(
        "diff_epoch=1")
    fresh = port_state()
    assert ttrain.restore_train_state(fresh, str(tmp_path), args,
                                      "RESUME_RECENT") == 1
    for n, entry in ttr.optimizer_state(fresh).items():
        for k, v in entry.items():
            assert torch.equal(v, saved[n][k]), (n, k)
    tckpt.purge_checkpoints(str(tmp_path), "opt")
    assert tckpt.latest_checkpoint_path(str(tmp_path), "opt") is None


SMOKE = {"arg_num": "tsmoke", "img_size": [32, 32], "Batch_Size": 2,
         "EPOCHS": 2, "T": 10, "base_channels": 32, "channel_mults": [1, 2],
         "attention_resolutions": "16", "beta_schedule": "cosine",
         "loss-type": "l2", "lr": 1e-4, "sample_distance": 8,
         "train_start": True, "noise_fn": "simplex", "dataset": "synthetic",
         "iters_per_epoch": 1, "checkpoint_every": 1, "save_imgs": False,
         "save_vids": False, "seed": 0, "compute_dtype": "float32"}


def test_train_entry_point_on_cpu_with_resume(tmp_path, monkeypatch, capsys):
    """train() on the CPU: epochs 0..2 at one step each, the epoch-0 VLB
    sweep, periodic and final checkpoints with AdamW's state, the train
    JSONL and the test-set suite; then RESUME_RECENT from the epoch-2
    checkpoint (kept by patching out the purge, as after a crash)."""
    root = str(tmp_path)
    args = defaultdict_from_json(dict(SMOKE))
    monkeypatch.setattr(ttrain, "purge_checkpoints", lambda *a, **k: None)
    state = ttrain.train(args, root_dir=root, max_epochs=2, device="cpu")
    assert state.step == 3
    assert "total VLB" in capsys.readouterr().out
    base = os.path.join(root, "model", "diff-params-ARGS=tsmoke")
    payload, meta = tckpt.load_checkpoint(root, "tsmoke")
    assert meta["n_epoch"] == 2 and payload["opt"]
    assert {float(e["step"]) for e in payload["opt"].values()} == {3.0}
    assert sorted(os.listdir(os.path.join(base, "checkpoint"))) == [
        "diff_epoch=1", "diff_epoch=2"]
    with open(os.path.join(root, "metrics", "argstsmoke-train.jsonl")) as f:
        record = json.loads(f.readline())
    assert record["step"] == 1 and np.isfinite(record["loss"])
    with open(os.path.join(root, "metrics", "argstsmoke-test.json")) as f:
        results = json.load(f)
    assert all(np.isfinite(results[k]) for k in ("total_vlb", "psnr"))

    resumed = ttrain.train(defaultdict_from_json({**SMOKE, "skip_test_eval": True}),
                           root_dir=root, resume="RESUME_RECENT", max_epochs=3,
                           device="cpu")
    assert "resumed from epoch 2" in capsys.readouterr().out
    assert resumed.step == 2                   # epochs 2 and 3
    payload, meta = tckpt.load_checkpoint(root, "tsmoke")
    assert meta["n_epoch"] == 3
    assert {float(e["step"]) for e in payload["opt"].values()} == {5.0}


def test_train_substeps_1_and_8_are_bit_equal(tmp_path, capsys):
    """train() at train_substeps 1 and 8 (the band recipe's 8 steps per
    dispatch) on the s2d64 recipe's layout at 32^2 (space-to-depth 2, bf16),
    iters_per_epoch 8, epochs 0..2 with the epoch-0 VLB sweep: the final
    parameters, the EMA and AdamW's state are bit-equal, and so is the
    VLB line.  Each step draws t and then its noise from the one
    generator, the sweep draws after the epoch's last step, and the data
    order does not depend on the substeps: so a model trained at one step
    per dispatch is a seed of the band recipe."""
    states, vlb = {}, {}
    for substeps in (1, 8):
        args = defaultdict_from_json({**SMOKE, "iters_per_epoch": 8,
                                      "train_substeps": substeps,
                                      "space_to_depth": 2,
                                      "compute_dtype": "bfloat16",
                                      "checkpoint_every": 1000,
                                      "skip_test_eval": True})
        states[substeps] = ttrain.train(args, root_dir=str(tmp_path / str(substeps)),
                                        max_epochs=2, device="cpu")
        vlb[substeps] = [line.split(", VLB sweep")[0]
                         for line in capsys.readouterr().out.splitlines()
                         if "total VLB" in line]
    one, eight = states[1], states[8]
    assert one.step == eight.step == 24
    assert vlb[1] == vlb[8] and len(vlb[1]) == 1
    for name, a in one.model.state_dict().items():
        assert torch.equal(a, eight.model.state_dict()[name]), name
    for name, a in one.ema.state_dict().items():
        assert torch.equal(a, eight.ema.state_dict()[name]), name
    opt1, opt8 = ttr.optimizer_state(one), ttr.optimizer_state(eight)
    assert sorted(opt1) == sorted(opt8) == sorted(
        n for n, _ in one.model.named_parameters())
    for name, entry in opt1.items():
        assert sorted(entry) == ["exp_avg", "exp_avg_sq", "step"]
        for k, v in entry.items():
            assert torch.equal(v, opt8[name][k]), (name, k)
    assert float(opt1[name]["step"]) == 24.0


class StandIn(torch.nn.Module):
    """A one-layer stand-in for the UNet: eps = 0.1 conv1x1(x)."""

    def __init__(self):
        super().__init__()
        self.conv = torch.nn.Conv2d(1, 1, 1)

    def forward(self, x, t):
        return 0.1 * self.conv(x)


def test_unported_options_raise(tmp_path):
    """remat and train_substeps > 1 run now (an unknown remat policy
    raises): 2 substeps of iters_per_epoch 4 take 4 steps an epoch in 2
    dispatches; save_imgs, save_vids and testing(save_videos=True) write
    their files (the epoch-0 sample grid; the test-set video at lambda =
    100)."""
    tsched = ts.make_schedule(ts.get_beta_schedule(T, "cosine"))
    with pytest.raises(ValueError, match="remat"):
        ttr.make_train_step(tsched, None, remat="all")
    args = defaultdict_from_json({**SMOKE, "arg_num": "tsub", "train_substeps": 2,
                                  "iters_per_epoch": 4, "skip_test_eval": True})
    state = ttrain.train(args, root_dir=str(tmp_path), max_epochs=0,
                         device="cpu")
    assert state.step == 4
    root = tmp_path / "art"
    args = defaultdict_from_json({**SMOKE, "arg_num": "tsave", "save_imgs": True,
                                  "save_vids": True, "skip_test_eval": True})
    ttrain.train(args, root_dir=str(root), max_epochs=0, device="cpu")
    assert os.listdir(root / "diffusion-training-images" / "ARGS=tsave") == [
        "EPOCH=0.png"]
    from anoddpm_torch.evaluation import testing
    long = ts.make_schedule(ts.get_beta_schedule(101, "cosine"))
    loader = tpipe.batch_iterator(dataset_from_args(".", defaultdict_from_json(
        {"img_size": (32, 32)})), 1)
    results = testing(loader, StandIn(), long, defaultdict_from_json(
        {"arg_num": "tv", "sample_distance": 101}), root_dir=str(root),
        n_images=1, save_videos=True)
    assert np.isfinite(results["psnr"])
    videos = os.listdir(root / "diffusion-videos" / "ARGS=tv" / "test-set")
    assert [os.path.splitext(v)[0] for v in videos] == ["t=100"]
    with pytest.raises(SystemExit):
        ttrain.main([])


def test_prefetch_raises_the_producers_error_and_stops():
    def broken():
        yield {"image": np.zeros((1, 4, 4, 1), np.float32)}
        raise OSError("unreadable slice")
    loader = tpipe.prefetch_to_device(broken(), "cpu")
    assert next(loader)["image"].shape == (1, 1, 4, 4)
    with pytest.raises(OSError, match="unreadable"):
        next(loader)
    endless = tpipe.prefetch_to_device(
        tpipe.batch_iterator(dataset_from_args(".", defaultdict_from_json(
            {"img_size": (8, 8)})), 2), "cpu", size=1)
    next(endless)
    endless.close()             # stops and joins the producer thread
    assert not [t for t in threading.enumerate()
                if t.name == "prefetch_to_device" and t.is_alive()]


def test_observe_logger_timer_and_profile_window(tmp_path, monkeypatch):
    from anoddpm_torch.observe import MetricsLogger, ProfileWindow, StepTimer
    log = MetricsLogger(str(tmp_path / "m" / "train.jsonl"))
    log.log(3, loss=torch.tensor(0.5), note="x")
    log.close()
    record = json.loads((tmp_path / "m" / "train.jsonl").read_text())
    assert record["step"] == 3 and record["loss"] == 0.5 and record["note"] == "x"
    timer = StepTimer(warmup=1)
    for _ in range(4):
        timer.tick()
    assert timer.count == 3 and timer.mean >= 0
    assert ProfileWindow("off").dir is None or os.environ.get("ANODDPM_PROFILE_DIR")
    monkeypatch.setenv("ANODDPM_PROFILE_DIR", str(tmp_path / "prof"))
    window = ProfileWindow("run", epoch_index=0)
    window.start_epoch(0)
    torch.ones(8).sum()
    window.end_epoch(0)
    assert (tmp_path / "prof" / "run" / "trace.json").exists()
