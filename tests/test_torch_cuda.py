"""The port's CUDA kernels against their plain PyTorch versions on the card.

These tests carry the `cuda` marker and skip without a CUDA device.  On a
machine with a card (and no JAX), run them with

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""
import pytest
import torch

from anoddpm_torch.ops import group_norm_silu as gn
from anoddpm_torch.ops import simplex as sx

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("n,h,w", [(3, 64, 64), (2, 37, 50)])
def test_simplex_kernel_matches_plain(cuda, n, h, w):
    gen = torch.Generator(device=cuda).manual_seed(0)
    seeds = torch.randint(0, 1 << 32, (n,), generator=gen, device=cuda,
                          dtype=torch.int64)
    t = torch.rand(n, generator=gen, device=cuda) * 999
    before = sx.batched_fractal3_fixed_t.launches
    got = sx.batched_fractal3_fixed_t(seeds, t, (h, w))
    assert sx.batched_fractal3_fixed_t.launches == before + 1
    want = sx._fractal3_fixed_t_plain(seeds, t, (h, w), 6, 0.8, 64.0)
    assert got.shape == (n, h, w) and torch.isfinite(got).all()
    assert ((got - want).abs() <= 1e-5).float().mean().item() >= 0.997


@pytest.mark.parametrize("shape", [(2, 64, 16, 16), (1, 96, 7, 9),
                                   (4, 256, 64, 64),
                                   (72, 1024, 2, 2)])  # N*C > 65535 planes
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_group_norm_silu_kernel_matches_plain(cuda, shape, dtype):
    gen = torch.Generator(device=cuda).manual_seed(1)
    x = (torch.randn(shape, generator=gen, device=cuda) * 2 + 0.5).to(dtype)
    gamma = 1 + 0.1 * torch.randn(shape[1], generator=gen, device=cuda)
    beta = 0.1 * torch.randn(shape[1], generator=gen, device=cuda)
    before = gn.group_norm_silu.launches
    got, mean, rstd = gn.group_norm_silu_with_stats(x, gamma, beta)
    assert gn.group_norm_silu.launches == before + 1
    want, wmean, wrstd = gn._plain(x, gamma, beta, 1e-5)
    assert got.dtype == dtype
    torch.testing.assert_close(mean, wmean, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(rstd, wrstd, atol=1e-5, rtol=1e-4)
    diff = (got.float() - want.float()).abs()
    if dtype == torch.float32:
        assert (diff <= 1e-4 + 1e-4 * want.abs()).all()
    else:
        ulp = torch.exp2(torch.floor(torch.log2(want.float().abs().clamp_min(1e-30))) - 7)
        assert (diff <= ulp.clamp_min(1e-4)).all()


def test_group_norm_silu_rejects_channels_last(cuda):
    x = torch.randn(1, 64, 8, 8, device=cuda).to(memory_format=torch.channels_last)
    with pytest.raises(ValueError, match="contiguous"):
        gn.group_norm_silu(x, torch.ones(64, device=cuda), torch.zeros(64, device=cuda))
