"""The frozen FLOP count and bytes bounds against the port's recorded
numbers (`results/torch_chain_flops.json`, PERF.md's bounds)."""

import json

import pytest

from benchmark.core import yardstick as ys
from benchmark.tests.tiny import ROOT


def cfg(name):
    """The paper's configuration, or "s2d64": the same UNet at base 64 behind
    a 2x space-to-depth stem, the port's `configs/args256syn64s2d.json`,
    whose recorded count the frozen arithmetic also reproduces."""
    c = json.loads((ROOT / "benchmark/configs/paper128.json").read_text())
    if name == "s2d64":
        c.update(base_channels=64, space_to_depth=2)
    return c


def test_forward_flops_match_the_port():
    recorded = json.loads((ROOT / "results/torch_chain_flops.json").read_text())
    assert ys.forward_flops_per_image(cfg("paper128")) == 554_517_659_648
    assert ys.forward_flops_per_image(cfg("s2d64")) == 36_708_188_160
    assert recorded["paper_b8"]["fwd_flops_per_img"] == 554_517_659_648
    assert recorded["headline_b32_s2d"]["fwd_flops_per_img"] == 36_708_188_160


def test_train_flops_are_forward_and_backward():
    for name in ("paper128", "s2d64"):
        ratio = (ys.train_flops_per_image(cfg(name))
                 / ys.forward_flops_per_image(cfg(name)))
        assert 2.99 < ratio <= 3.0     # the stem's input takes no gradient


@pytest.mark.parametrize("name,batch,bound_ms,sites", [
    ("paper128", 4, 0.986, 85), ("s2d64", 4, 0.125, 71)])
def test_k2_bytes_bound(name, batch, bound_ms, sites):
    c = cfg(name)
    assert ys.k2_sites(c) == sites
    ms = ys.k2_bytes_per_forward(c, batch) / ys.HBM_BYTES_PER_S * 1e3
    assert abs(ms - bound_ms) < 5e-4


@pytest.mark.parametrize("name,bound_ms", [("paper128", 2.957), ("s2d64", 0.374)])
def test_k2b_bytes_bound(name, bound_ms):
    ms = ys.k2b_bytes_per_step(cfg(name), 8) / ys.HBM_BYTES_PER_S * 1e3
    assert abs(ms - bound_ms) < 5e-4


def test_kind_of():
    assert ys.kind_of("void group_norm_silu_bwd_sum_kernel(float const*)") \
        == "K2b group_norm_silu backward"
    assert ys.kind_of("void group_norm_silu_kernel<__nv_bfloat16, 0>(Params)") \
        == "K2 group_norm_silu"
    assert ys.kind_of("sm90_xmma_fprop_implicit_gemm") == "conv forward"
    assert ys.kind_of("something") == "other"
