"""K2 and K2b's flax order (`group_norm_silu(..., order="flax")`) on the
CPU, where it is the plain composition: equal bit for bit to `_flax_site`
and its autograd as the UNet ran them before the order became a kernel
mode, and held to the JAX package's `GroupNorm32` + `nn.silu` under the
flax-site rule of PERF.md section 2; the UNet under `norm_impl="flax"`
unchanged; F3's rounding A/B (`seed_replication --norm-order flax`, `band
--flax-order`) on recorders and fixture numbers.  The kernels themselves
are held to this plain version on the card (`tests/test_torch_cuda.py`,
`chip_smoke.py`)."""
import json
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anoddpm_torch.campaigns import band, seed_replication
from anoddpm_torch.models import unet as port_unet
from anoddpm_torch.ops import group_norm_silu as gn
from test_torch_norm_paths import jax_site, site_inputs, unet_inputs, unet_pair
from torch_parity import nchw, nhwc

DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
# (C, H, W) of the norm+SiLU sites of args256syn128 (85) and
# args256syn64s2d (71, at 128^2 after its space-to-depth), every channel
# count kept and the planes cut 16 x on each side (at least 1 x 1), so
# that every fp32 sum of the statistics of `site_inputs` stays exact.
PAPER_SITES = [(128, 256), (256, 256), (128, 128), (256, 128), (384, 128),
               (128, 64), (256, 64), (384, 64), (512, 64), (256, 32),
               (512, 32), (768, 32), (256, 16), (512, 16), (768, 16),
               (1024, 16), (512, 8), (1024, 8)]
S2D64_SITES = [(64, 128), (128, 128), (64, 64), (128, 64), (192, 64),
               (64, 32), (128, 32), (192, 32), (256, 32), (320, 32),
               (128, 16), (192, 16), (256, 16), (320, 16), (384, 16),
               (448, 16), (192, 8), (256, 8), (448, 8), (512, 8)]
SITES = sorted({(c, max(h // 16, 1), max(h // 16, 1))
                for c, h in PAPER_SITES + S2D64_SITES})


def counts():
    return (gn.group_norm_silu.launches, gn.group_norm_silu.flax_launches,
            gn.group_norm_silu_backward.launches,
            gn.group_norm_silu_backward.flax_launches)


def old_route(x, gamma, beta, bf16_path):
    """The flax-order site as `unet.flax_norm` computed it before the order
    became a mode of K2 and K2b: `_FlaxSite` under autograd, `_flax_site`
    without."""
    if torch.is_grad_enabled() and (x.requires_grad or gamma.requires_grad
                                    or beta.requires_grad):
        return gn._FlaxSite.apply(x, gamma, beta, bf16_path, True)
    return gn._flax_site(x, gamma, beta, bf16_path, True)


def grads_of(fn, x, gamma, beta, g):
    xs, gs, bs = (t.clone().requires_grad_() for t in (x, gamma, beta))
    out = fn(xs, gs, bs)
    out.backward(g)
    return [out.detach(), xs.grad, gs.grad, bs.grad]


@pytest.mark.parametrize("bf16_path", [False, True])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("chw", SITES)
def test_wrapper_equals_flax_site(chw, dtype, bf16_path):
    """Forward (with and without autograd) and backward bit for bit, at
    N = 2, with no kernel launch counted."""
    tdtype = DTYPES[dtype][0]
    gen = torch.Generator().manual_seed(chw[0] + chw[1])
    shape = (2,) + chw
    x = (torch.randn(shape, generator=gen) * 1.7 + 0.4).to(tdtype)
    gamma = 1 + 0.1 * torch.randn(chw[0], generator=gen)
    beta = 0.1 * torch.randn(chw[0], generator=gen)
    g = torch.randn(shape, generator=gen).to(tdtype)
    before = counts()
    got = grads_of(lambda *a: gn.group_norm_silu_flax(*a, bf16_path), x, gamma,
                   beta, g)
    want = grads_of(lambda *a: old_route(*a, bf16_path), x, gamma, beta, g)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
    with torch.no_grad():
        assert torch.equal(gn.group_norm_silu(x, gamma, beta, order="flax"),
                           gn._flax_site(x, gamma, beta, bf16_path, True))
    assert counts() == before


@pytest.mark.parametrize("bf16_path", [False, True])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("chw", SITES)
def test_wrapper_matches_jax_composition(chw, dtype, bf16_path):
    """Against `nn.silu(GroupNorm32(bf16_path)(x))`, eager `jax.vjp`, at
    N = 2, under PERF.md's flax-site rule as it reads at every site shape
    of both models.  The statistics' sums are exact, but XLA's rsqrt and exp
    on the CPU differ from torch's in the last fp32 bit on 35% and 10% of
    inputs, and over these 40 shapes that moves more than at the rule's
    first three: bf16: the output equal to JAX's in all but 1 in 10^4
    elements (1 in 49,152 measured), those within 2 bf16 ulps of max(|h|,
    |out|), h the norm's output (h an ulp apart carries up to 1.1 ulps of
    it through SiLU, the output's rounding one more); dx bit-equal in >= 99.5% of elements and within one bf16 ulp of
    its largest magnitude; dgamma and dbeta within 2^-12 of their largest
    magnitude (1.02e-4 measured, beside an output element an ulp apart);
    fp32: the output within 8 ulps of its largest magnitude (5 measured),
    dx, dgamma and dbeta within 1e-5 of theirs."""
    tdtype, jdtype = DTYPES[dtype]
    c, h, w = chw
    x, g, gamma, beta = site_inputs((2, h, w, c), seed=c + h)
    want = jax_site(x, g, gamma, beta, bf16_path, jdtype)
    tx = nchw(x).to(tdtype).requires_grad_()
    tg = torch.from_numpy(gamma).requires_grad_()
    tb = torch.from_numpy(beta).requires_grad_()
    out = gn.group_norm_silu(tx, tg, tb, order="flax", bf16_path=bf16_path)
    out.backward(nchw(g).to(tdtype))
    got = (nhwc(out.detach().float()), nhwc(tx.grad.float()),
           tg.grad.numpy(), tb.grad.numpy())
    if dtype == "bfloat16":
        assert (got[0] != want[0]).mean() <= 1e-4
        with torch.no_grad():
            norm = nhwc(gn._flax_site(tx, tg, tb, bf16_path, False).float())
        big = np.maximum(np.abs(norm), np.abs(want[0]))
        ulp = np.exp2(np.floor(np.log2(np.maximum(big, 1e-30))) - 7)
        assert (np.abs(got[0] - want[0]) <= 2 * ulp).all()
        assert (got[1] == want[1]).mean() >= 0.995
        np.testing.assert_allclose(got[1], want[1], rtol=0,
                                   atol=np.abs(want[1]).max() / 2 ** 7)
        param_tol = 2 ** -12
    else:
        np.testing.assert_allclose(got[0], want[0], rtol=0, atol=8 * np.spacing(
            np.abs(want[0]).max()))
        np.testing.assert_allclose(got[1], want[1], rtol=0,
                                   atol=1e-5 * np.abs(want[1]).max())
        param_tol = 1e-5
    for k in (2, 3):
        np.testing.assert_allclose(got[k], want[k], rtol=0,
                                   atol=param_tol * np.abs(want[k]).max())


@pytest.mark.parametrize("bf16_path", [False, True])
def test_plain_entries_of_the_flax_order(bf16_path):
    """`group_norm_silu_with_stats` and `group_norm_silu_backward` in the
    flax order on the CPU: the composition's output with flax's statistics,
    and its autograd (the same bits as through `GroupNormSiLU`)."""
    gen = torch.Generator().manual_seed(5)
    x = (torch.randn((2, 64, 8, 8), generator=gen) * 1.7).bfloat16()
    gamma = 1 + 0.1 * torch.randn(64, generator=gen)
    beta = 0.1 * torch.randn(64, generator=gen)
    g = torch.randn(x.shape, generator=gen).bfloat16()
    out, mean, rstd = gn.group_norm_silu_with_stats(x, gamma, beta, order="flax")
    xg = x.float().reshape(2, 32, -1)
    assert torch.equal(out, gn._flax_site(x, gamma, beta, False, True))
    assert torch.equal(mean, xg.mean(-1))
    torch.testing.assert_close(rstd, torch.rsqrt(xg.var(-1, unbiased=False) + 1e-5))
    dx, dgamma, dbeta = gn.group_norm_silu_backward(
        x, g, gamma, beta, mean, rstd, order="flax", bf16_path=bf16_path)
    want = grads_of(lambda *a: gn.group_norm_silu_flax(*a, bf16_path), x, gamma,
                    beta, g)
    for a, b in zip((out, dx, dgamma, dbeta), want):
        assert torch.equal(a, b)


def test_order_arguments_are_checked():
    x, gamma, beta = torch.zeros((1, 32, 2, 2)), torch.ones(32), torch.zeros(32)
    with pytest.raises(ValueError, match="order"):
        gn.group_norm_silu(x, gamma, beta, order="xla")
    with pytest.raises(ValueError, match="bf16_path"):
        gn.group_norm_silu(x, gamma, beta, bf16_path=True)
    with pytest.raises(ValueError, match="order"):
        gn.group_norm_silu_backward(x, x, gamma, beta, x[:, :, 0, 0],
                                    x[:, :, 0, 0], order="jax")


@pytest.mark.parametrize("bf16_norm", [False, True])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("s2d", [1, 2])
def test_unet_flax_unchanged(s2d, dtype, bf16_norm):
    """`UNet(norm_impl="flax")` at 32^2: the output and every parameter's
    gradient equal, bit for bit, those of the same UNet whose norm+SiLU
    sites take the route of before the mode (`old_route`)."""
    _, _, port = unet_pair(s2d, bf16_norm, False, dtype)
    x, t, gout = unet_inputs()
    runs = []
    for route in (None, old_route):
        patch = (mock.patch.object(port_unet, "group_norm_silu_flax", route)
                 if route else mock.patch.dict({}))
        with patch:
            port.zero_grad(set_to_none=True)
            out = port(nchw(x), torch.from_numpy(t.astype(np.int64)))
            out.backward(nchw(gout))
        runs.append([out.detach()] + [p.grad.clone()
                                      for p in port.parameters()])
    assert len(runs[0]) == len(runs[1]) > 1
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_train_args_for_the_flax_order():
    """The override gives the JAX band's norm keys and its own token; the
    default order is the config's, under the tokens it had before."""
    flax = seed_replication.train_args_for("256syn64s2d", 3, norm_order="flax")
    kernel = seed_replication.train_args_for("256syn64s2d", 3)
    assert flax["arg_num"] == "256syn64s2d_s3_flaxorder"
    assert kernel["arg_num"] == "256syn64s2d_s3"
    assert (flax["norm_impl"], flax["bf16_norm"], flax["pallas_norm"]) == (
        "flax", False, False)
    assert "norm_impl" not in kernel and kernel["bf16_norm"] is True
    norm_keys = ("norm_impl", "bf16_norm", "pallas_norm", "arg_num")
    assert {k: v for k, v in flax.items() if k not in norm_keys} == {
        k: v for k, v in kernel.items() if k not in norm_keys}
    with torch.device("meta"):
        model = port_unet.unet_from_args(flax, 1)
    assert {(m.norm_impl, m.bf16_norm) for m in model.modules()
            if isinstance(m, port_unet.GroupNorm32)} == {("flax", False)}
    assert seed_replication.results_name([0, 1], "flax") == \
        "results/torch_f3_flax_order_seeds01.json"
    assert seed_replication.results_name([0]) == "results/torch_seed_replication.json"


def test_run_in_the_flax_order_writes_its_own_file(tmp_path):
    """`run(..., norm_order="flax")` trains the order's tokens and writes its
    entries to its own results file, leaving the default order's file alone."""
    calls = []

    def ensure(config, seed, root_dir, device, norm_order):
        calls.append((config, seed, norm_order))
        return f"{config}_s{seed}_flaxorder"

    def load(root_dir, token, device):
        return {"token": token}, None, None

    def metric(args, root_dir, em, sched, device):
        return {m: 0.25 for m in seed_replication.METRICS}

    with mock.patch.object(seed_replication, "ensure_trained", ensure), \
            mock.patch.object(seed_replication, "_load_eval_model", load), \
            mock.patch.object(seed_replication, "anomalous_metric_calculation",
                              metric):
        res = seed_replication.main(["4", "--skip=paper128", "--norm-order",
                                     "flax", "--root", str(tmp_path)],
                                    device="cpu")
    assert calls == [("256syn64s2d", 4, "flax")]
    written = json.loads((tmp_path / "results" /
                          "torch_f3_flax_order_seeds4.json").read_text())
    assert written == res
    assert set(k for k in res if k.endswith("/seed4")) == {
        f"{c}/seed4" for c in seed_replication.MODELS["256syn64s2d"]}
    assert not (tmp_path / "results" / "torch_seed_replication.json").exists()


def _fixture(root, flax_dice, kernel_dice, jax_dice, jax_auc=None):
    """Results files of the three samples: every s2d64 cell holds Dice
    from the given five values (shifted per cell) and AUC from a fixed
    spread, the flax-order seeds split over two files."""
    cells = seed_replication.MODELS["256syn64s2d"]
    auc = jax_auc or [0.70, 0.72, 0.74, 0.71, 0.73]
    sample = lambda dice: {
        f"{c}/seed{s}": {"auc": auc[s] + 0.001 * i, "dice": dice[s] + 0.01 * i,
                         "iou": 0.1, "ssim": 0.6}
        for i, c in enumerate(cells) for s in range(5)}
    (root / "results").mkdir(exist_ok=True)
    flax = sample(flax_dice)
    for part in ("012", "34"):
        (root / "results" / f"torch_f3_flax_order_seeds{part}.json").write_text(
            json.dumps({k: v for k, v in flax.items()
                        if k[-1] in part}))
    (root / "results" / "torch_seed_replication.json").write_text(
        json.dumps(sample(kernel_dice)))
    (root / "jax.json").write_text(json.dumps(sample(jax_dice)))


WIDE = [0.14, 0.20, 0.16, 0.17, 0.21]        # sigma ~ .028
NARROW = [0.165, 0.160, 0.168, 0.162, 0.166]  # sigma ~ .003


@pytest.mark.parametrize("flax,kernel,jax,verdict", [
    (NARROW, WIDE, NARROW, "the norm's order"),
    (WIDE, WIDE, NARROW, "not the norm's order"),
    ([0.16, 0.175, 0.15, 0.17, 0.165], WIDE, NARROW, "open"),
])
def test_band_runs_the_two_comparisons(tmp_path, flax, kernel, jax, verdict):
    """`band --flax-order` on fixture numbers: (i) the flax-order seeds
    against the JAX file and (ii) against the default-order file, each by
    the two-sample rule, and the verdict of PERF.md section 2's rule."""
    _fixture(tmp_path, flax, kernel, jax)
    out = band.main(["--root", str(tmp_path), "--flax-order", "--jax",
                     str(tmp_path / "jax.json")])
    assert out["verdict"] == verdict
    assert out["files"] == ["results/torch_f3_flax_order_seeds012.json",
                            "results/torch_f3_flax_order_seeds34.json"]
    for key, other in (("vs_jax", jax), ("vs_kernel_order", kernel)):
        res = out[key]
        row = res["cells"]["s2d64_ddim20_eta1"]["dice"]
        side = res["sides"][1]
        assert row[side]["std"] == pytest.approx(np.std(other, ddof=1))
        assert row["flax_order"]["std"] == pytest.approx(np.std(flax, ddof=1))
        assert len(res["holm"]["f"]) == len(res["holm"]["welch"]) == 18
    written = json.loads((tmp_path / "results" /
                          "torch_f3_flax_order_two_sample.json").read_text())
    assert written["verdict"] == verdict
    pair = written["paired_flax_minus_kernel"]["s2d64_ddim20_eta1"]["dice"]
    assert pair["diff"] == pytest.approx([f - k for f, k in zip(flax, kernel)])
    assert pair["max_abs"] == pytest.approx(max(abs(f - k)
                                                for f, k in zip(flax, kernel)))


def test_band_refuses_files_that_disagree(tmp_path):
    _fixture(tmp_path, NARROW, WIDE, NARROW)
    path = tmp_path / "results" / "torch_f3_flax_order_seeds34.json"
    entries = json.loads(path.read_text())
    key = next(iter(entries))
    (tmp_path / "results" / "torch_f3_flax_order_seeds3.json").write_text(
        json.dumps({key: {**entries[key], "dice": 0.5}}))
    with pytest.raises(ValueError, match="differs"):
        band.main(["--root", str(tmp_path), "--flax-order", "--jax",
                   str(tmp_path / "jax.json")])
