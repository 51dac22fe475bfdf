"""The launch layout of kernel K2 (`group_norm_silu.plan`), checked on the
CPU: every shape one args256syn128 UNet forward gives K2 at batch 4 (the
headline protocol) and at batch 1, 19 and 32 (the detection suite) gets a
layout the card can take, and shapes the kernel does not take raise."""
import pytest
import torch

from anoddpm_torch.ops import group_norm_silu as gn

SMEM_PER_BLOCK = 227 * 1024   # the most an sm_90 block can opt into
# (C, H = W) of the 85 norm+SiLU sites of args256syn128 (18 distinct).
UNET_SHAPES = [(128, 256), (256, 256), (128, 128), (256, 128), (384, 128),
               (128, 64), (256, 64), (384, 64), (512, 64), (256, 32),
               (512, 32), (768, 32), (256, 16), (512, 16), (768, 16),
               (1024, 16), (512, 8), (1024, 8)]


@pytest.mark.parametrize("n", [4, 1, 19, 32])
@pytest.mark.parametrize("c,h", UNET_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plan_fits_the_card(c, h, dtype, n):
    size = torch.finfo(dtype).bits // 8
    group_len = c // 32 * h * h
    p = gn.plan(n, c, h * h, dtype)
    assert 1 <= p.cluster <= gn.MAX_CLUSTER
    assert 32 <= p.threads <= gn.MAX_THREADS and p.threads % 32 == 0
    assert p.slice_len * size % 16 == 0
    # the blocks of a group cover it, and none is empty
    assert (p.cluster - 1) * p.slice_len < group_len <= p.cluster * p.slice_len
    assert p.smem_bytes in (0, p.slice_len * size)
    assert p.smem_bytes <= min(gn.STAGE_MAX_BYTES, SMEM_PER_BLOCK)
    # no thread of a block is without a 16-byte vector
    assert p.threads <= p.slice_len * size // 16
    # the grid: one block per (sample, group, slice)
    assert n * 32 * p.cluster < 2 ** 31


@pytest.mark.parametrize("c,h", UNET_SHAPES)
def test_unet_sites_are_staged(c, h):
    """At the dtype the UNet runs each site in (bf16, and fp32 at the
    output norm) the slice is staged in shared memory: x is read once."""
    dtypes = [torch.bfloat16] + ([torch.float32] if (c, h) == (128, 256) else [])
    for dtype in dtypes:
        p = gn.plan(4, c, h * h, dtype)
        assert p.smem_bytes == p.slice_len * (torch.finfo(dtype).bits // 8)


def test_plan_uses_clusters_for_large_groups():
    assert gn.plan(4, 256, 256 * 256, torch.bfloat16).cluster == 16
    assert gn.plan(4, 128, 256 * 256, torch.float32).cluster == 16
    assert gn.plan(4, 512, 8 * 8, torch.bfloat16).cluster == 1


def test_plan_reads_twice_beyond_the_staging_budget():
    p = gn.plan(1, 1024, 512 * 512, torch.float32)   # 32 MB groups
    assert p.cluster == gn.MAX_CLUSTER and p.smem_bytes == 0
    assert p.cluster * p.slice_len >= 32 * 512 * 512


@pytest.mark.parametrize("hw", [1, 63])
def test_plan_of_ragged_planes_is_not_staged(hw):
    p = gn.plan(1, 96, hw, torch.bfloat16)
    assert p.cluster == 1 and p.smem_bytes == 0 and p.threads == 32


@pytest.mark.parametrize("c", [0, 48, 100])
def test_plan_raises_on_channels_not_a_multiple_of_32(c):
    with pytest.raises(ValueError):
        gn.plan(4, c, 64, torch.bfloat16)


def test_plan_raises_on_other_dtypes_and_empty_x():
    with pytest.raises(TypeError):
        gn.plan(4, 64, 64, torch.float16)
    with pytest.raises(ValueError):
        gn.plan(0, 64, 64, torch.float32)
    with pytest.raises(ValueError):
        gn.plan(4, 64, 0, torch.float32)


# K2b (`group_norm_silu.backward_plan`) at the training batch: its slices
# hold x and grad_out together.
TRAIN_BATCH = 8
TWO_MB = 2 * 1024 * 1024


@pytest.mark.parametrize("c,h", UNET_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_plan_fits_the_card(c, h, dtype):
    size = torch.finfo(dtype).bits // 8
    group_len = c // 32 * h * h
    p = gn.backward_plan(TRAIN_BATCH, c, h * h, dtype)
    assert 1 <= p.cluster <= 16
    # 256 threads at most where both slices are staged, else 512
    top = 256 if p.smem_bytes == 2 * p.slice_len * size else 512
    assert 32 <= p.threads <= top and p.threads % 32 == 0
    assert p.slice_len * size % 16 == 0
    # the blocks of a group cover it, and none is empty
    assert (p.cluster - 1) * p.slice_len < group_len <= p.cluster * p.slice_len
    # staged: the slices of x and grad_out, that of x alone, or nothing
    assert p.smem_bytes in (0, p.slice_len * size, 2 * p.slice_len * size)
    assert p.smem_bytes <= min(gn.BACKWARD_STAGE_MAX_BYTES, SMEM_PER_BLOCK)
    # no thread of a block is without a 16-byte vector
    assert p.threads <= p.slice_len * size // 16


@pytest.mark.parametrize("c,h", UNET_SHAPES)
def test_backward_unet_sites_read_once(c, h):
    """At the dtype the UNet runs each site in (bf16, and fp32 at the
    output norm) the slices of x and grad_out are staged, so that both are
    read from device memory once; only the groups of 2 MB (x + grad_out)
    take the chosen other path: clusters of 16 blocks that stage the slice
    of x and read grad_out twice, the second time mostly from L2."""
    dtypes = [torch.bfloat16] + ([torch.float32] if (c, h) == (128, 256) else [])
    for dtype in dtypes:
        size = torch.finfo(dtype).bits // 8
        p = gn.backward_plan(TRAIN_BATCH, c, h * h, dtype)
        if 2 * c // 32 * h * h * size == TWO_MB:
            assert p.cluster == 16 and p.smem_bytes == p.slice_len * size
        else:
            assert p.smem_bytes == 2 * p.slice_len * size


@pytest.mark.parametrize("c", [0, 48, 100])
def test_backward_plan_raises_on_channels_not_a_multiple_of_32(c):
    with pytest.raises(ValueError):
        gn.backward_plan(TRAIN_BATCH, c, 64, torch.bfloat16)


def test_backward_plan_raises_on_other_dtypes_and_empty_x():
    with pytest.raises(TypeError):
        gn.backward_plan(TRAIN_BATCH, 64, 64, torch.float16)
    with pytest.raises(ValueError):
        gn.backward_plan(0, 64, 64, torch.float32)
    with pytest.raises(ValueError):
        gn.backward_plan(TRAIN_BATCH, 64, 0, torch.float32)
