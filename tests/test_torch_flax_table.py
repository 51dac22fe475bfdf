"""The flax order's sigmoid table (K2's and K2b's bf16 sites) on the CPU.

`ops.group_norm_silu._flax_table_lookup` is the plain counterpart of the
kernels' lookup (`flax_table_index` in csrc/cluster_staging.cuh): the same
slots, filled from one h each.  Here it is held bit for bit against the
op-by-op `_JaxSiLU` and `_flax_site` at all 65,536 bf16 values of h, NaN
held only to be NaN (on the CPU a NaN keeps its payload through the ops;
the card's arithmetic gives one NaN, which `tests/test_torch_cuda.py` and
chip_smoke phase 17 hold bit for bit)."""
import numpy as np
import torch

from anoddpm_torch.ops import group_norm_silu as gn

BITS = torch.arange(65536, dtype=torch.int32)


def _same(a, b):
    """Where a and b have the same bits, or are both NaN."""
    return (a.view(torch.int16) == b.view(torch.int16)) | (a.isnan() & b.isnan())


def test_lookup_equals_jax_silu_at_every_bf16_value():
    """s, ds, out and the gradient g s + (g h) ds, each op in bf16, from the
    table against `_JaxSiLU`'s forward and backward, at every h."""
    h = gn._bf16_from_bits(BITS)
    s, ds, out = gn._flax_table_lookup(h)
    s0 = gn._jax_logistic(h)
    assert bool(_same(s, s0).all())
    assert bool(_same(ds, s0 * (1 - s0)).all())
    assert bool(_same(out, gn._JaxSiLU.apply(h)).all())
    g = torch.from_numpy(np.random.default_rng(0).standard_normal(65536)
                         .astype(np.float32)).to(torch.bfloat16)
    ctx = type("Ctx", (), {"saved_tensors": (h, s0)})()
    assert bool(_same(g * s + (g * h) * ds, gn._JaxSiLU.backward(ctx, g)).all())
    # every slot but the two NaN ones is a number
    assert int(torch.isnan(gn._plain_flax_table()[0]).sum()) == 2


def test_lookup_equals_flax_site_at_every_bf16_value():
    """`_flax_site` on x = 0 with beta = each bf16 value: its norm output h
    (beta itself, -0 turned +0) and its output out = silu(h) in bf16, held
    against the table's out at that h."""
    c = 65536
    x = torch.zeros(1, c, 1, 1, dtype=torch.bfloat16)
    gamma = torch.ones(c)
    beta = gn._bf16_from_bits(BITS).float()
    h = gn._flax_site(x, gamma, beta, False, False).flatten()
    out = gn._flax_site(x, gamma, beta, False, True).flatten()
    assert bool(_same(h, beta.to(torch.bfloat16)).sum() >= c - 1)
    assert bool(_same(gn._flax_table_lookup(h)[2], out).all())


def test_table_slots_and_their_constant_ranges():
    """The layout: 1,923 slots a sign, the 3,840 bf16 values of |h| in
    [2^-8, 2^7) one slot each, every |h| < 2^-8 in slot 0 with s = 1/2 and
    ds = 1/4, every |h| >= 2^7 in slot 1921 with (1, 0) for h > 0 and (0, 0)
    for h < 0, NaN in slot 1922."""
    h = gn._bf16_from_bits(BITS)
    i = gn._flax_table_index(BITS)
    e = BITS & 0x7FFF
    inside = (e >= 119 << 7) & (e < 134 << 7)
    assert int(inside.sum()) == 3840
    assert torch.unique(i[inside]).numel() == 3840
    k = i % gn.FLAX_TABLE_ROW
    assert set(k[~inside & ~h.isnan()].tolist()) == {0, 1921}
    assert set(k[h.isnan()].tolist()) == {1922}
    assert bool(((i >= gn.FLAX_TABLE_ROW) == (BITS >= 0x8000)).all())
    # the values of h where (s, ds) is none of the three constants all lie
    # in the table's range (2,916 of them on the CPU)
    s0 = gn._jax_logistic(h)
    pair = torch.stack([s0.float(), (s0 * (1 - s0)).float()], 1)
    const = torch.tensor([[0.5, 0.25], [1.0, 0.0], [0.0, 0.0]])
    varying = ~((pair[:, None] == const).all(-1).any(-1) | h.isnan())
    assert int(varying.sum()) == 2916 and bool(inside[varying].all())
    s, ds = (t.float() for t in gn._plain_flax_table())
    row = gn.FLAX_TABLE_ROW
    assert (s[0], ds[0], s[row], ds[row]) == (0.5, 0.25, 0.5, 0.25)
    assert (s[1921], ds[1921], s[row + 1921], ds[row + 1921]) == (1, 0, 0, 0)
