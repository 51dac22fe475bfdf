"""The launch plan of kernel K1 (`simplex.launch_plan`), checked on the CPU:
the grid never exceeds what the card holds, its warps reach every warp tile
of the output, and shapes the kernel does not take raise."""
import pytest

from anoddpm_torch.ops import simplex as sx

H100_SMS = 132


def warp_tiles(n, h, w):
    return n * -(-h // sx.TILE_H) * -(-w // sx.TILE_W)


def test_warp_tile_holds_one_warp():
    assert sx.TILE_H * sx.TILE_W == 32


@pytest.mark.parametrize("n,h,w", [(4, 256, 256), (1, 1, 1), (2, 255, 257),
                                   (64, 32, 32), (1, 64, 64), (8, 256, 256)])
@pytest.mark.parametrize("warps,per_sm", [(16, 2), (8, 4), (32, 1)])
def test_plan_covers_every_tile(n, h, w, warps, per_sm):
    resident = per_sm * H100_SMS
    blocks = sx.launch_plan(n, h, w, warps, resident)
    tiles = warp_tiles(n, h, w)
    assert 1 <= blocks <= resident
    # no block without a tile, and the grid-stride walk reaches every tile
    assert (blocks - 1) * warps < tiles
    reached = set()
    for block in range(blocks):
        for warp in range(warps):
            reached.update(range(warp * blocks + block, tiles, warps * blocks))
    assert reached == set(range(tiles))


def test_main_path_fills_the_card():
    """4 fields of 256^2: 8,192 warp tiles over all 264 blocks of 16 warps,
    no warp more than one tile ahead of another."""
    blocks = sx.launch_plan(4, 256, 256, 16, 2 * H100_SMS)
    assert blocks == 2 * H100_SMS
    per_warp = warp_tiles(4, 256, 256) / (blocks * 16)
    assert 1 < per_warp <= 2


@pytest.mark.parametrize("n,h,w", [(0, 8, 8), (1, 0, 8), (1, 8, 0)])
def test_plan_raises_on_empty_output(n, h, w):
    with pytest.raises(ValueError):
        sx.launch_plan(n, h, w, 16, 264)


def test_plan_raises_beyond_int32_tiles():
    with pytest.raises(ValueError):
        sx.launch_plan(1 << 16, 1 << 12, 1 << 12, 16, 264)
    with pytest.raises(ValueError):
        sx.launch_plan(1, 1, 2 ** 31, 16, 264)


def test_plan_raises_without_resident_blocks():
    with pytest.raises(ValueError):
        sx.launch_plan(1, 8, 8, 16, 0)
