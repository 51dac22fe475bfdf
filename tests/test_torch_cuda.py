"""The port's CUDA kernels (K1, K2 and K2b, K2's gradient) against their
plain PyTorch versions on the card.

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


def _check_simplex_kernel(seeds, t, hw, octaves=6, frequency=64.0):
    """One K1 launch against the plain version: within 1e-5 on >= 99.7% of
    the pixels (a floor() may flip at an exact cell boundary), all finite."""
    before = sx.batched_fractal3_fixed_t.launches
    got = sx.batched_fractal3_fixed_t(seeds, t, hw, octaves, 0.8, frequency)
    assert sx.batched_fractal3_fixed_t.launches == before + 1
    want = sx._fractal3_fixed_t_plain(seeds, t, hw, octaves, 0.8, frequency)
    assert got.shape == (seeds.shape[0], *hw) and torch.isfinite(got).all()
    assert ((got - want).abs() <= 1e-5).float().mean().item() >= 0.997
    return got


@pytest.mark.parametrize("n,h,w,octaves,frequency,t_value", [
    (1, 64, 64, 6, 64.0, None),        # one field
    (2, 1, 1, 6, 64.0, None),          # one pixel
    (2, 255, 257, 6, 64.0, None),      # ragged in both axes
    (64, 32, 32, 6, 64.0, None),       # many fields
    (4, 64, 64, 1, 64.0, None),        # one octave
    (4, 64, 64, 8, 64.0, None),        # eight octaves
    (4, 64, 64, 6, 16.0, None),        # mixed warps from octave 0
    (4, 64, 64, 6, 64.0, 999.0),       # the last timestep
])
def test_simplex_kernel_shapes(cuda, n, h, w, octaves, frequency, t_value):
    gen = torch.Generator(device=cuda).manual_seed(n * 1000 + h + w)
    seeds = torch.randint(0, 1 << 32, (n,), generator=gen, device=cuda,
                          dtype=torch.int64)
    t = (torch.full((n,), t_value, device=cuda) if t_value is not None
         else torch.rand(n, generator=gen, device=cuda) * 999)
    _check_simplex_kernel(seeds, t, (h, w), octaves, frequency)


@pytest.mark.parametrize("frequency", [2.0, 128.0])
@pytest.mark.parametrize("n", [1, 32])
def test_simplex_kernel_suite_frequencies(cuda, frequency, n):
    """The detection suite's extremes at 256^2: method A_fixedT's frequency
    2 (the top octave 16 lattice units a pixel, coordinates past 4,000)
    and method A's 128, for one field and a lambda chunk of 32."""
    gen = torch.Generator(device=cuda).manual_seed(int(frequency) + n)
    seeds = torch.randint(0, 1 << 32, (n,), generator=gen, device=cuda,
                          dtype=torch.int64)
    t = torch.arange(n, device=cuda, dtype=torch.float32) * 5 + 249
    _check_simplex_kernel(seeds, t, (256, 256), 6, frequency)


def test_simplex_kernel_share_batch(cuda):
    """The sampler with share_batch: one K1 launch for the C fields, each
    repeated over the batch, equal to the plain fields of the same seeds."""
    from anoddpm_torch.ops import noise
    before = sx.batched_fractal3_fixed_t.launches
    got = noise.simplex_noise((3, 2, 40, 48), torch.tensor([7, 9, 11]),
                              torch.Generator(device=cuda).manual_seed(5),
                              share_batch=True)
    assert sx.batched_fractal3_fixed_t.launches == before + 1
    seeds = noise._seeds(2, torch.Generator(device=cuda).manual_seed(5))
    want = sx._fractal3_fixed_t_plain(seeds, torch.full((2,), 7.0, device=cuda),
                                      (40, 48), 6, 0.8, 64.0)
    assert got.shape == (3, 2, 40, 48)
    for b in range(3):
        assert ((got[b] - want).abs() <= 1e-5).float().mean().item() >= 0.997


def test_simplex_kernel_attributes(cuda):
    """As built: no spills, and the card holds its blocks."""
    attr = sx.attributes(torch.cuda.current_device())
    assert attr.local_bytes == 0 and attr.blocks_per_sm >= 1
    assert attr.resident == attr.blocks_per_sm * torch.cuda.get_device_properties(
        0).multi_processor_count


def test_simplex_kernel_takes_other_dtypes_and_strides(cuda):
    """int32 seeds and a strided fp64 t are converted, not refused."""
    gen = torch.Generator(device=cuda).manual_seed(4)
    seeds = torch.randint(0, 1 << 31, (3,), generator=gen, device=cuda,
                          dtype=torch.int64)
    t = torch.rand(6, generator=gen, device=cuda, dtype=torch.float64)[::2] * 99
    got = sx.batched_fractal3_fixed_t(seeds.int(), t, (33, 20))
    want = _check_simplex_kernel(seeds, t.float(), (33, 20))
    torch.testing.assert_close(got, want, atol=0, rtol=0)


def _rand_param_rows():
    from anoddpm_torch.ops.noise import RAND_PARAM_TABLE
    return RAND_PARAM_TABLE


@pytest.mark.parametrize("row", range(23))
def test_simplex_kernel_params_from_device(cuda, row):
    """K1's parameters-from-device entry at each RAND_PARAM_TABLE triple:
    one launch counted with K1's, against its masked plain version and
    equal to the static entry at the same triple."""
    octaves, pers, freq = _rand_param_rows()[row]
    gen = torch.Generator(device=cuda).manual_seed(20 + row)
    seeds = torch.randint(0, 1 << 32, (4,), generator=gen, device=cuda,
                          dtype=torch.int64)
    t = torch.tensor([0.0, 57.0, 123.0, 199.0], device=cuda)
    params = torch.tensor([octaves, pers, freq], device=cuda)
    before = sx.batched_fractal3_fixed_t.launches
    got = sx.batched_fractal3_fixed_t_params(seeds, t, (96, 80), params)
    assert sx.batched_fractal3_fixed_t.launches == before + 1
    want = sx._fractal3_fixed_t_params_plain(seeds, t, (96, 80), params)
    assert torch.isfinite(got).all()
    assert ((got - want).abs() <= 1e-5).float().mean().item() >= 0.997
    static = sx.batched_fractal3_fixed_t(seeds, t, (96, 80), octaves,
                                         float(params[1]), float(params[2]))
    torch.testing.assert_close(got, static, atol=0, rtol=0)


def test_noise_kinds_on_the_card_without_sync(cuda):
    """randParam, random and the volume draw on the card with one K1 launch
    each and no host sync; the table and 2-D kinds run as plain PyTorch."""
    from anoddpm_torch.ops import noise
    gen = torch.Generator(device=cuda).manual_seed(3)
    t = torch.tensor([5, 40], device=cuda)
    for kind in ("simplex_randParam", "random"):
        sampler = noise.make_noise_sampler(kind)
        before = sx.batched_fractal3_fixed_t.launches
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = sampler((2, 1, 64, 64), t, gen)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert sx.batched_fractal3_fixed_t.launches == before + 1
        assert out.is_cuda and torch.isfinite(out).all()
    before = sx.batched_fractal3_fixed_t.launches
    vol = noise.simplex_volume_noise((5, 32, 48), gen, octaves=3)
    assert vol.shape == (5, 32, 48)
    assert sx.batched_fractal3_fixed_t.launches == before + 1
    for kind, table in (("simplex", True), ("simplex_2d", False)):
        out = noise.make_noise_sampler(kind, table=table)((2, 1, 32, 32), t, gen)
        assert out.is_cuda and torch.isfinite(out).all()


def _check_group_norm_silu(x, gamma, beta):
    """One K2 call against the plain version: output within atol = rtol =
    1e-4 (fp32) or one bf16 ulp (1e-4 floor), mean and rstd within 1e-5."""
    before = gn.group_norm_silu.launches
    got, mean, rstd = gn.group_norm_silu_with_stats(x, gamma, beta)
    assert gn.group_norm_silu.launches == before + 1
    assert torch.equal(gn.group_norm_silu(x, gamma, beta), got)  # no stats kept
    want, wmean, wrstd = gn._plain(x, gamma, beta, 1e-5)
    assert got.dtype == x.dtype and mean.shape == rstd.shape == (x.shape[0], 32)
    torch.testing.assert_close(mean, wmean, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(rstd, wrstd, atol=1e-5, rtol=1e-4)
    diff = (got.float() - want.float()).abs()
    if x.dtype == torch.float32:
        assert (diff <= 1e-4 + 1e-4 * want.float().abs()).all()
    else:
        ulp = torch.exp2(torch.floor(torch.log2(want.float().abs().clamp_min(1e-30))) - 7)
        assert (diff <= ulp.clamp_min(1e-4)).all()


def _inputs(shape, dtype, device, seed=1):
    gen = torch.Generator(device=device).manual_seed(seed)
    x = (torch.randn(shape, generator=gen, device=device) * 2 + 0.5).to(dtype)
    gamma = 1 + 0.1 * torch.randn(shape[1], generator=gen, device=device)
    beta = 0.1 * torch.randn(shape[1], generator=gen, device=device)
    return x, gamma, beta


@pytest.mark.parametrize("shape", [(2, 64, 16, 16), (1, 96, 7, 9),
                                   (4, 256, 64, 64),
                                   (72, 1024, 2, 2),  # N*C > 65535 planes
                                   (1, 32, 1, 1)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_group_norm_silu_kernel_matches_plain(cuda, shape, dtype):
    _check_group_norm_silu(*_inputs(shape, dtype, cuda))


@pytest.mark.parametrize("n", [1, 32])
@pytest.mark.parametrize("c,h", [(128, 256), (256, 128), (512, 32), (1024, 8)])
def test_group_norm_silu_suite_batches(cuda, n, c, h):
    """args256syn128 sites at the detection suite's batch 1 (methods,
    validation) and 32 (graph's lambda chunk), in bf16 as the UNet runs
    them."""
    _check_group_norm_silu(*_inputs((n, c, h, h), torch.bfloat16, cuda, seed=n))


@pytest.mark.parametrize("shape,dtype", [((4, 256, 256, 256), torch.bfloat16),
                                         ((4, 128, 256, 256), torch.float32),
                                         ((2, 256, 256, 256), torch.float32)])
def test_group_norm_silu_cluster_shapes(cuda, shape, dtype):
    """Groups of 1-2 MB: clusters of 16 blocks (the last one read twice
    instead of staged)."""
    assert gn.plan(shape[0], shape[1], shape[2] * shape[3], dtype).cluster == 16
    _check_group_norm_silu(*_inputs(shape, dtype, cuda))


@pytest.mark.parametrize("offset", [1, 3])
def test_group_norm_silu_unaligned_x(cuda, offset):
    """x at a storage offset that breaks 16-byte alignment."""
    x, gamma, beta = _inputs((2, 64, 32, 32), torch.bfloat16, cuda)
    flat = torch.empty(x.numel() + offset, dtype=x.dtype, device=cuda)
    xu = flat[offset:].view(x.shape)
    xu.copy_(x)
    assert xu.data_ptr() % 16 != 0 and xu.is_contiguous()
    _check_group_norm_silu(xu, gamma, beta)


def test_group_norm_silu_is_one_kernel_launch(cuda):
    from torch.profiler import ProfilerActivity, profile
    x, gamma, beta = _inputs((4, 256, 64, 64), torch.bfloat16, cuda)
    gn.group_norm_silu(x, gamma, beta)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        gn.group_norm_silu(x, gamma, beta)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert [e.name for e in kernels if "group_norm_silu" in e.name] and len(kernels) == 1, \
        [e.name for e in kernels]


def test_group_norm_silu_rejects_channels_last(cuda):
    x = torch.randn(1, 64, 8, 8, device=cuda).to(memory_format=torch.channels_last)
    with pytest.raises(ValueError, match="contiguous"):
        gn.group_norm_silu(x, torch.ones(64, device=cuda), torch.zeros(64, device=cuda))


# (C, H, W) of the 85 K2 sites of args256syn128's UNet (the training batch
# is 8); out_norm's (128, 256, 256) site runs in fp32, the others in bf16.
TRAIN_SITES = [(512, 8, 8), (1024, 8, 8), (256, 16, 16), (512, 16, 16),
               (768, 16, 16), (1024, 16, 16), (256, 32, 32), (512, 32, 32),
               (768, 32, 32), (128, 64, 64), (256, 64, 64), (384, 64, 64),
               (512, 64, 64), (128, 128, 128), (256, 128, 128),
               (384, 128, 128), (128, 256, 256), (256, 256, 256)]


def _check_group_norm_silu_backward(x, grad_out, gamma, beta):
    """One K2b call against the plain backward: dx within atol = rtol =
    1e-4 (fp32) or one bf16 ulp (1e-4 floor); dgamma and dbeta within 1e-4
    of their largest magnitude (fp32 sums in another order)."""
    _, mean, rstd = gn.group_norm_silu_with_stats(x, gamma, beta)
    before = gn.group_norm_silu_backward.launches
    dx, dgamma, dbeta = gn.group_norm_silu_backward(x, grad_out, gamma, beta,
                                                    mean, rstd)
    assert gn.group_norm_silu_backward.launches == before + gn.BACKWARD_LAUNCHES
    want = gn._plain_backward(x, grad_out, gamma, beta, mean, rstd)
    assert dx.dtype == x.dtype and dgamma.dtype == dbeta.dtype == torch.float32
    diff = (dx.float() - want[0].float()).abs()
    if x.dtype == torch.float32:
        assert (diff <= 1e-4 + 1e-4 * want[0].abs()).all(), diff.max()
    else:
        ulp = torch.exp2(torch.floor(torch.log2(want[0].float().abs().clamp_min(1e-30))) - 7)
        assert (diff <= ulp.clamp_min(1e-4)).all(), diff.max()
    for got, w in ((dgamma, want[1]), (dbeta, want[2])):
        assert (got - w).abs().max() <= 1e-4 * w.abs().max().clamp_min(1e-30)
    return dx, dgamma, dbeta


@pytest.mark.parametrize("chw", TRAIN_SITES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_group_norm_silu_backward_sites(cuda, chw, dtype):
    x, gamma, beta = _inputs((8,) + chw, dtype, cuda, seed=chw[0] + chw[1])
    grad_out = torch.randn(x.shape, device=cuda).to(dtype)
    _check_group_norm_silu_backward(x, grad_out, gamma, beta)


@pytest.mark.parametrize("shape", [(1, 32, 1, 1), (2, 96, 7, 9), (3, 64, 33, 17)])
def test_group_norm_silu_backward_odd_shapes(cuda, shape):
    """Groups of one element, and planes that are not a whole number of
    16-byte vectors (scalar accesses)."""
    for dtype in (torch.float32, torch.bfloat16):
        x, gamma, beta = _inputs(shape, dtype, cuda)
        _check_group_norm_silu_backward(
            x, torch.randn(shape, device=cuda).to(dtype), gamma, beta)


def test_group_norm_silu_backward_is_deterministic(cuda):
    x, gamma, beta = _inputs((8, 128, 256, 256), torch.bfloat16, cuda)
    grad_out = torch.randn(x.shape, device=cuda).to(torch.bfloat16)
    _, mean, rstd = gn.group_norm_silu_with_stats(x, gamma, beta)
    first = gn.group_norm_silu_backward(x, grad_out, gamma, beta, mean, rstd)
    again = gn.group_norm_silu_backward(x, grad_out, gamma, beta, mean, rstd)
    assert all(torch.equal(a, b) for a, b in zip(first, again))


def test_autograd_through_kernels_matches_plain(cuda):
    """The differentiable call at a 16^2 fp32 shape, with a non-contiguous
    output gradient (the output read through a transpose): one K2 launch
    with statistics and one K2b call; gradients equal the CPU Function's
    (plain forward and backward) within 1e-5."""
    x, gamma, beta = _inputs((2, 64, 16, 16), torch.float32, cuda)
    weight = torch.randn((2, 64, 16, 16), device=cuda)
    grads = {}
    for dev in (cuda, torch.device("cpu")):
        xs, gs, bs = (t.to(dev).clone().requires_grad_() for t in (x, gamma, beta))
        k2, k2b = gn.group_norm_silu.launches, gn.group_norm_silu_backward.launches
        y = gn.group_norm_silu(xs, gs, bs)
        (y.transpose(2, 3) * weight.to(dev)).sum().backward()
        if dev.type == "cuda":
            assert gn.group_norm_silu.launches == k2 + 1
            assert gn.group_norm_silu_backward.launches == k2b + gn.BACKWARD_LAUNCHES
        grads[dev.type] = [t.grad.cpu() for t in (xs, gs, bs)]
    for got, want in zip(grads["cuda"], grads["cpu"]):
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


def test_group_norm_silu_backward_rejects_channels_last(cuda):
    x, gamma, beta = _inputs((1, 64, 8, 8), torch.float32, cuda)
    _, mean, rstd = gn.group_norm_silu_with_stats(x, gamma, beta)
    xl = x.to(memory_format=torch.channels_last)
    with pytest.raises(ValueError, match="contiguous"):
        gn.group_norm_silu_backward(xl, xl, gamma, beta, mean, rstd)
    with pytest.raises(ValueError, match="contiguous"):
        gn.group_norm_silu_backward(x, torch.ones_like(xl), gamma, beta,
                                    mean, rstd)


def _backward_inputs(shape, dtype, device, seed=2):
    x, gamma, beta = _inputs(shape, dtype, device, seed)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    return x, torch.randn(shape, generator=gen, device=device).to(dtype), gamma, beta


@pytest.mark.parametrize("shape,dtype", [((2, 128, 256, 256), torch.bfloat16),
                                         ((2, 256, 256, 256), torch.bfloat16),
                                         ((2, 128, 256, 256), torch.float32),
                                         ((2, 256, 256, 256), torch.float32)])
def test_group_norm_silu_backward_cluster_shapes(cuda, shape, dtype):
    """Groups of 1 MB (x + grad_out, staged at 64 KB a block), 2 MB (x
    staged, grad_out read twice) and 4 MB (nothing staged, scalar passes):
    clusters of 16 blocks; a rerun gives the same bits."""
    p = gn.backward_plan(shape[0], shape[1], shape[2] * shape[3], dtype)
    assert p.cluster == 16
    args = _backward_inputs(shape, dtype, cuda)
    first = _check_group_norm_silu_backward(*args)
    again = _check_group_norm_silu_backward(*args)
    assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.parametrize("hw", [1, 63])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_group_norm_silu_backward_ragged_planes(cuda, hw, dtype):
    """H W not a multiple of the 16-byte vector: scalar passes."""
    _check_group_norm_silu_backward(*_backward_inputs((3, 96, 1, hw), dtype, cuda))


@pytest.mark.parametrize("which", ["x", "grad_out"])
@pytest.mark.parametrize("offset", [1, 3])
def test_group_norm_silu_backward_unaligned(cuda, which, offset):
    """x or grad_out at a storage offset that breaks 16-byte alignment, at a
    shape whose plan stages the slices."""
    x, go, gamma, beta = _backward_inputs((2, 128, 64, 64), torch.bfloat16, cuda)
    t = x if which == "x" else go
    flat = torch.empty(t.numel() + offset, dtype=t.dtype, device=cuda)
    tu = flat[offset:].view(t.shape)
    tu.copy_(t)
    assert tu.data_ptr() % 16 != 0 and tu.is_contiguous()
    if which == "x":
        x = tu
    else:
        go = tu
    assert gn.backward_plan(2, 128, 64 * 64, torch.bfloat16).smem_bytes > 0
    _check_group_norm_silu_backward(x, go, gamma, beta)


@pytest.mark.parametrize("n", [1, 8])
@pytest.mark.parametrize("chw", [(256, 32, 32), (128, 128, 128)])
def test_group_norm_silu_backward_batch_sizes(cuda, n, chw):
    """dgamma and dbeta add the samples' sums: one sample, and eight, with
    one block and with a cluster per group."""
    _check_group_norm_silu_backward(*_backward_inputs((n,) + chw,
                                                      torch.bfloat16, cuda))


def test_group_norm_silu_backward_back_to_back(cuda):
    """Calls on one stream with no sync between them and other N, then the
    first shape again: each call's dgamma and dbeta add its own samples."""
    shapes = [(3, 256, 16, 16), (5, 256, 16, 16), (3, 256, 16, 16)]
    inputs = [_backward_inputs(s, torch.bfloat16, cuda, seed=k)
              for k, s in enumerate(shapes)]
    stats = [gn.group_norm_silu_with_stats(x, g_, b_)[1:]
             for x, _, g_, b_ in inputs]
    got = [gn.group_norm_silu_backward(x, go, g_, b_, *st)
           for (x, go, g_, b_), st in zip(inputs, stats)]
    for (x, go, g_, b_), st, res in zip(inputs, stats, got):
        want = gn._plain_backward(x, go, g_, b_, *st)
        for a, w in zip(res[1:], want[1:]):
            assert (a - w).abs().max() <= 1e-4 * w.abs().max()


def test_group_norm_silu_backward_two_streams(cuda):
    """Calls running at once on two streams give each its own gradients."""
    args = [_backward_inputs((4, 512, 16, 16), torch.bfloat16, cuda, seed=k)
            for k in range(2)]
    stats = [gn.group_norm_silu_with_stats(x, g_, b_)[1:] for x, _, g_, b_ in args]
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream() for _ in args]
    got = []
    for s, (x, go, g_, b_), st in zip(streams, args, stats):
        with torch.cuda.stream(s):
            got.append([gn.group_norm_silu_backward(x, go, g_, b_, *st)
                        for _ in range(20)][-1])
    torch.cuda.synchronize()
    for (x, go, g_, b_), st, res in zip(args, stats, got):
        want = gn._plain_backward(x, go, g_, b_, *st)
        for a, w in zip(res[1:], want[1:]):
            assert (a - w).abs().max() <= 1e-4 * w.abs().max()


@pytest.mark.parametrize("shape", [(8, 512, 8, 8), (8, 128, 256, 256)])
def test_group_norm_silu_backward_launches_per_call(cuda, shape):
    """One call is BACKWARD_LAUNCHES kernels, all K2b's, and nothing else."""
    from torch.profiler import ProfilerActivity, profile
    x, go, gamma, beta = _backward_inputs(shape, torch.bfloat16, cuda)
    _, mean, rstd = gn.group_norm_silu_with_stats(x, gamma, beta)
    gn.group_norm_silu_backward(x, go, gamma, beta, mean, rstd)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        gn.group_norm_silu_backward(x, go, gamma, beta, mean, rstd)
        torch.cuda.synchronize()
    kernels = {e.key: e.count for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA}
    assert sum(kernels.values()) == gn.BACKWARD_LAUNCHES and all(
        "group_norm_silu_bwd" in k for k in kernels), \
        (kernels, [e.key for e in prof.key_averages()])


# args256syn64s2d's top-level K2 site: 256^2 images after a space-to-depth
# of 2 run the UNet at 128^2 with base 64, so GroupNorm(32) has 2 channels
# per group; batch 4 in detection, 8 in training.
S2D64_TOP = (64, 128, 128)


@pytest.mark.parametrize("n", [4, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_group_norm_silu_s2d64_top(cuda, n, dtype):
    _check_group_norm_silu(*_inputs((n,) + S2D64_TOP, dtype, cuda, seed=n))


@pytest.mark.parametrize("n", [4, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_group_norm_silu_backward_s2d64_top(cuda, n, dtype):
    x, gamma, beta = _inputs((n,) + S2D64_TOP, dtype, cuda, seed=n + 1)
    grad_out = torch.randn(x.shape, device=cuda).to(dtype)
    _check_group_norm_silu_backward(x, grad_out, gamma, beta)


# The JAX package's norm composition (`norm_impl="flax"`): plain PyTorch, the
# same ops on the card as on the CPU, held to each other under chip_smoke's
# rules (`FLAX_SITE_*` there): the GroupNorm output h rounds once (K2's
# rule); the SiLU on the card's own h against the CPU's, in bf16 within 2
# ulps of max(|h|, |out|) (one per-op rounding going the other way moves it
# by at most that); dx bit-equal in >= 99% and within 4 bf16 ulps of its
# largest magnitude (fp32 1e-4); dgamma, dbeta within one bf16 ulp of their
# largest magnitude (fp32 1e-4).
def _flax_site(x, gamma, beta, grad_out, bf16_path):
    from anoddpm_torch.models.unet import flax_norm
    x, gamma, beta = (t.detach().requires_grad_() for t in (x, gamma, beta))
    with torch.no_grad():
        norm = flax_norm(x, gamma, beta, bf16_path, False)
    out = flax_norm(x, gamma, beta, bf16_path, True)
    out.backward(grad_out)
    return [t.detach().float().cpu() for t in (norm, out, x.grad, gamma.grad,
                                               beta.grad)]


def _bf16_ulp(v):
    return torch.exp2(torch.floor(torch.log2(v.abs().clamp_min(1e-30))) - 7)


@pytest.mark.parametrize("bf16_path", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 64, 16, 16), (1, 192, 8, 8),
                                   (4,) + S2D64_TOP])
def test_flax_site_on_card_matches_cpu(cuda, shape, dtype, bf16_path):
    from anoddpm_torch.models.unet import _JaxSiLU
    x, gamma, beta = _inputs(shape, dtype, cuda, seed=7)
    grad_out = torch.randn(shape, device=cuda).to(dtype)
    got = _flax_site(x, gamma, beta, grad_out, bf16_path)
    want = _flax_site(x.cpu(), gamma.cpu(), beta.cpu(), grad_out.cpu(), bf16_path)
    with torch.no_grad():
        silu = _JaxSiLU.apply(got[0].to(dtype)).float()
    bf16 = dtype == torch.bfloat16
    for g, w, ref, ulps in ((got[0], want[0], want[0], 1),
                            (got[1], silu, torch.maximum(got[0].abs(), silu.abs()), 2)):
        diff = (g - w).abs()
        if bf16:
            assert (diff <= torch.clamp(ulps * _bf16_ulp(ref), min=1e-4)).all()
        else:
            assert (diff <= 1e-4 + 1e-4 * w.abs()).all()
    assert ((got[2] - want[2]).abs().max()
            <= (2 ** -5 if bf16 else 1e-4) * want[2].abs().max())
    assert not bf16 or (got[2] == want[2]).float().mean() >= 0.99
    for i in (3, 4):
        assert ((got[i] - want[i]).abs().max()
                <= (2 ** -7 if bf16 else 1e-4) * want[i].abs().max())


@pytest.mark.parametrize("pallas_norm", [False, True])
def test_flax_unet_takes_k2_at_eligible_sites(cuda, pallas_norm):
    """norm_impl="flax" on the card: no K2 without pallas_norm; with it one
    K2 per site whose NHWC shape passes the Pallas gate, and K2b there
    under autograd."""
    from anoddpm_torch.models.unet import NormSiLU, UNet
    torch.manual_seed(0)
    model = UNet(img_size=32, base_channels=64, channel_mults=(1, 2),
                 attention_resolutions="16", dtype=torch.bfloat16,
                 norm_impl="flax", bf16_norm=True, pallas_norm=pallas_norm)
    shapes = []
    for m in model.modules():
        if isinstance(m, NormSiLU):
            m.register_forward_pre_hook(
                lambda mod, inp: shapes.append((inp[0].shape, inp[0].dtype)))
    x = torch.randn((2, 1, 32, 32))
    t = torch.tensor([3, 17])
    model.to(cuda)
    k2, k2b = gn.group_norm_silu.launches, gn.group_norm_silu_backward.launches
    out = model(x.to(cuda), t.to(cuda))
    out.sum().backward()
    torch.cuda.synchronize()
    eligible = sum(gn.eligible((n, h, w, c), dtype)
                   for (n, c, h, w), dtype in shapes) if pallas_norm else 0
    assert eligible > 0 or not pallas_norm
    assert gn.group_norm_silu.launches - k2 == eligible
    assert (gn.group_norm_silu_backward.launches - k2b
            == eligible * gn.BACKWARD_LAUNCHES)
    assert torch.isfinite(out).all()
