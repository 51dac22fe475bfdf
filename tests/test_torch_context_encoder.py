"""The port's context-encoder baseline against the JAX package's.

The flax model's parameters are carried into the port
(`compat.flax_params.context_encoder_state_dict_from_flax`); masks are
injected, never drawn on both sides.

- forward: within 1e-5;
- one masked-L2 Adam step (`make_ce_train_step` with the JAX package's box
  mask patched to the injected one) against optax.adam: loss and updated
  parameters within 1e-6 (where the gradient exceeds 1e-3 of its largest
  magnitude; elsewhere Adam's step is lr times a ratio set by rounding);
- `sliding_window_inpaint` within 1e-5; `sliding_window_error`, the square
  of the reconstruction's error, within what the square makes of 1e-5;
- `ce_anomalous_metrics`: the CSV's header and cells (4 digits) and the
  ROC's AUC equal to 1e-4;
- the CLI and `train_context_encoder` run on the CPU."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from anoddpm_tpu import baselines as jbase
from anoddpm_tpu.config import defaultdict_from_json
from anoddpm_tpu.models import context_encoder as jce
from anoddpm_torch import baselines as tbase
from anoddpm_torch.compat.flax_params import context_encoder_state_dict_from_flax
from anoddpm_torch.models import context_encoder as tce
from torch_parity import nchw, nhwc

ARGS = {"img_size": [32, 32], "dataset": "synthetic", "anomalous_volumes": 1,
        "arg_num": "ce", "Batch_Size": 2}


@pytest.fixture(scope="module")
def models():
    fmodel = jce.ContextEncoder(base_channels=16)
    params = fmodel.init(jax.random.key(0), jnp.zeros((1, 32, 32, 1)),
                         jnp.zeros((1, 32, 32, 1)))
    port = tce.ContextEncoder(in_channels=1, base_channels=16)
    port.load_state_dict(context_encoder_state_dict_from_flax(params),
                         strict=True)
    return fmodel, params, port.eval()


def images(b=2, seed=0):
    return np.random.default_rng(seed).uniform(
        -1, 1, size=(b, 32, 32, 1)).astype(np.float32)


def box_mask(b=2):
    m = np.zeros((b, 32, 32, 1), np.float32)
    m[0, 4:12, 10:18] = 1
    m[1, 20:28, 2:10] = 1
    return m


def test_padding_is_flax_same():
    assert tce.same_padding(32, 4, 2) == (1, 1)
    assert tce.same_padding(32, 3, 2) == (0, 1)
    assert tce.same_padding(31, 4, 2) == (1, 2)
    assert tce.same_padding(32, 3, 1) == (1, 1)


def test_forward_matches_flax(models):
    fmodel, params, port = models
    x, m = images(), box_mask()
    want = np.asarray(fmodel.apply(params, jnp.asarray(x), jnp.asarray(m)))
    with torch.no_grad():
        got = nhwc(port(nchw(x), nchw(m)))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_adam_step_matches_optax(models, monkeypatch):
    fmodel, params, _ = models
    x, m = images(seed=1), box_mask()
    monkeypatch.setattr(jce, "random_box_mask", lambda key, shape: jnp.asarray(m))
    tx = optax.adam(2e-3)
    step = jce.make_ce_train_step(fmodel, tx)
    jparams = jax.tree_util.tree_map(jnp.array, params)
    new_params, _, jloss = step(jparams, tx.init(jparams), jnp.asarray(x),
                                jax.random.key(0))
    port = tce.ContextEncoder(in_channels=1, base_channels=16)
    port.load_state_dict(context_encoder_state_dict_from_flax(params))
    pstep = tce.make_ce_train_step(port, torch.optim.Adam(port.parameters(),
                                                          lr=2e-3))
    loss = pstep(nchw(x), torch.Generator(), mask=nchw(m))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-6)
    want = context_encoder_state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, new_params))
    # Adam's first step moves each element by lr g / (|g| + eps): where |g|
    # nears eps its size follows the gradient's last bits, so there it is
    # only held to lr
    gmax = max(float(p.grad.abs().max()) for p in port.parameters())
    for n, p in port.named_parameters():
        keep = p.grad.abs().numpy() > 1e-3 * gmax
        got, ref = p.detach().numpy(), want[n].numpy()
        np.testing.assert_allclose(got[keep], ref[keep], atol=1e-6, rtol=0,
                                   err_msg=n)
        assert np.abs(got - ref).max() <= 2e-3, n


def test_random_box_mask_covers_a_square():
    mask = tce.random_box_mask(torch.Generator().manual_seed(0), (3, 1, 32, 32))
    assert mask.shape == (3, 1, 32, 32)
    assert (mask.sum(dim=(1, 2, 3)) == 64).all()    # 8 x 8 boxes


@pytest.mark.parametrize("fn", ["sliding_window_error", "sliding_window_inpaint"])
def test_sliding_window_matches_flax(models, fn):
    """The inpainted image within 1e-5 (the forward's limit).  The error
    map is v = (r - x)^2 of each pixel's reconstruction r, so the square
    carries r's 1e-5 to 2 sqrt(v) 1e-5 + 1e-10, and each side's subtraction
    and square round v by 2u v more (u = 2^-24): the map is held within
    that, and within 1e-5 where 2 sqrt(v) <= 1 (v <= 1/4, the square does
    not magnify r's error).  The map reaches 10.4 here; against a float64
    run of the port's model, the map of JAX (jit) is off by up to 1.33e-5,
    JAX eager 1.78e-5, the port 0.88e-5."""
    fmodel, params, port = models
    x = images(seed=2)
    want = np.asarray(getattr(jce, fn)(fmodel, params, jnp.asarray(x), 4))
    got = nhwc(getattr(tce, fn)(port, nchw(x), 4))
    if fn == "sliding_window_inpaint":
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
        return
    v = np.abs(want.astype(np.float64))
    d = np.abs(got.astype(np.float64) - want)
    bound = 1e-5 * (2 * np.sqrt(v) + 1e-5) + 4 * 2.0 ** -24 * v
    assert (d <= np.maximum(bound, 1e-5)).all(), (d - bound).max()
    well = v <= 0.25
    assert well.mean() > 0.3 and (d[well] <= 1e-5).all(), d[well].max()


def test_ce_metrics_csv_and_roc_match_jax(models, tmp_path):
    fmodel, params, port = models
    out = {}
    for name, call in (
            ("jax", lambda root: jbase.ce_anomalous_metrics(
                fmodel, params, defaultdict_from_json(dict(ARGS)),
                root_dir=root, max_volumes=1)),
            ("port", lambda root: tbase.ce_anomalous_metrics(
                port, defaultdict_from_json(dict(ARGS)), root_dir=root,
                max_volumes=1))):
        root = tmp_path / name
        summary, roc = call(str(root))
        out[name] = (summary, roc,
                     (root / "metrics" / "argsce-ce.csv").read_text())
    (gs, (gf, gt, _), gcsv), (ws, (wf, wt, _), wcsv) = out["port"], out["jax"]
    assert gcsv.splitlines()[0] == wcsv.splitlines()[0] == \
        "dice,iou,precision,recall,fpr,auc"
    got = [float(c.split(" +- ")[i]) for c in gcsv.splitlines()[1].split(",")[:-1]
           for i in (0, 1)]
    want = [float(c.split(" +- ")[i]) for c in wcsv.splitlines()[1].split(",")[:-1]
            for i in (0, 1)]
    np.testing.assert_allclose(got, want, atol=1e-4 + 5e-5, rtol=0)
    from anoddpm_torch import metrics as tm
    assert abs(tm.auc(gf, gt) - tm.auc(wf, wt)) <= 1e-4


def test_train_and_cli_run_on_the_cpu(tmp_path, monkeypatch, capsys):
    args = defaultdict_from_json(dict(ARGS))
    model = tbase.train_context_encoder(args, root_dir=str(tmp_path), steps=2,
                                        batch_size=2, base_channels=8,
                                        device="cpu")
    assert not model.training
    assert "CE final loss" in capsys.readouterr().out
    monkeypatch.setattr(tbase, "load_args", lambda token: args)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(
        tbase, "train_context_encoder",
        lambda a, steps, device: model)
    tbase.main(["ce", "3"], device="cpu")
    assert "CE baseline:" in capsys.readouterr().out
    assert (tmp_path / "metrics" / "argsce-ce.csv").exists()
    with pytest.raises(SystemExit):
        tbase.main([])
