"""The Python side of the diffusion block's tiles (CPU): the plan list, the
shared memory each plan needs at each k, the plan a launch takes, and the
tile count the Logger partials are allocated by. The kernel itself runs only
on the card (``tests/test_torch_cuda.py``), where the C functions are held
against these mirrors.
"""

import pytest

from opticalflow2d_tpu_torch.kernels import diffusion_block as tdb
from opticalflow2d_tpu_torch.kernels.demons_fused import MAX_SMEM_BYTES

WIDE_48 = 21  # the largest k whose block fits an H100 thread block on 48 x 48
WIDEST = 29   # and on 32 x 32, the last plan


def test_plan_list_in_order_of_preference():
    assert tdb.DIFFUSION_PLANS == ((48, 48, 512), (32, 32, 256))


@pytest.mark.parametrize("k,plan,nbytes", [
    (1, (48, 48, 512), 4 * (7 * 50 * 50 + 1 * 16 * 2)),
    (8, (48, 48, 512), 4 * (7 * 64 * 64 + 8 * 16 * 2)),   # 115,712 B: two blocks an SM
    (16, (48, 48, 512), 4 * (7 * 80 * 80 + 16 * 16 * 2)),
    (21, (48, 48, 512), 4 * (7 * 90 * 90 + 21 * 16 * 2)),
    (8, (32, 32, 256), 4 * (7 * 48 * 48 + 8 * 8 * 2)),    # the layout before the redesign
    (22, (32, 32, 256), 4 * (7 * 76 * 76 + 22 * 8 * 2)),
    (29, (32, 32, 256), 4 * (7 * 90 * 90 + 29 * 8 * 2)),
])
def test_bytes_per_plan_and_k(k, plan, nbytes):
    """u twice and g, 7 planes of the tile extended by k a side, and the
    warps' Logger partials of each iteration."""
    assert 4 * tdb.diffusion_smem_floats(k, *plan) == nbytes


def test_main_k_takes_48_tiles_two_blocks_an_sm():
    """k = 8 (the default block_k) on 48 x 48: two blocks fill an SM's 228
    KiB exactly with their 1 KiB reservations."""
    assert tdb.diffusion_smem_bytes(8) == 115712 <= MAX_SMEM_BYTES
    assert tdb.diffusion_plan(8) == (48, 48, 512)
    assert 2 * (115712 + 1024) == 228 * 1024


@pytest.mark.parametrize("k", range(1, WIDEST + 1))
def test_each_k_takes_the_first_plan_that_fits(k):
    """k 1-21 on 48 x 48 (8 compiled in, the others at run time), 22-29 on
    32 x 32; bench.py's k = 16 takes the first plan."""
    p = tdb.diffusion_plan(k)
    earlier = tdb.DIFFUSION_PLANS[:tdb.DIFFUSION_PLANS.index(p)]
    assert 4 * tdb.diffusion_smem_floats(k, *p) <= MAX_SMEM_BYTES
    assert all(4 * tdb.diffusion_smem_floats(k, *q) > MAX_SMEM_BYTES for q in earlier)
    assert p == ((48, 48, 512) if k <= WIDE_48 else (32, 32, 256))
    assert tdb.diffusion_smem_bytes(k) == 4 * tdb.diffusion_smem_floats(k, *p)


def test_k_above_29_is_refused():
    """k = 30 fits no plan, nor the wrapper test's k = 64: the wrapper's
    shared-memory check raises."""
    assert [k for k in range(1, 65) if tdb.diffusion_plan(k)] == list(range(1, WIDEST + 1))
    for k in (30, 64):
        assert tdb.diffusion_plan(k) is None
        assert tdb.diffusion_smem_bytes(k) > MAX_SMEM_BYTES
    assert tdb.diffusion_smem_bytes(30) == 4 * (7 * 92 * 92 + 30 * 8 * 2)


@pytest.mark.parametrize("nx,ny,k,tiles", [
    (4, 4, 8, 1),            # one tile, all border
    (4, 4, 22, 1),
    (33, 1000, 8, 21),       # 1 x 21 tiles of 48 x 48
    (33, 1000, 22, 64),      # 2 x 32 tiles of 32 x 32
    (100, 77, 8, 6),         # 3 x 2
    (25, 77, 8, 2),          # a ragged 25-row strip: 1 x 2
    (51, 777, 16, 34),       # a strip of 1004 x 777 in 4: 2 x 17
    (1000, 777, 8, 357),     # 21 x 17
    (1024, 4096, 8, 1892),   # the timed strip: 22 x 86
    (4096, 4096, 8, 7396),
    (4096, 4096, 16, 7396),
])
def test_partials_rows_are_the_tile_count(nx, ny, k, tiles):
    tx, ty, _ = tdb.diffusion_plan(k)
    assert tdb.diffusion_tiles(nx, ny, k) == tiles == -(-nx // tx) * -(-ny // ty)


@pytest.mark.parametrize("k", [1, 3, 8, 9, 16])
def test_strip_pad_holds_the_cone(k):
    """The strip driver's pad is k rounded up to 8, at least the k rows of
    the dependence cone the kernel needs."""
    assert tdb.required_pad(k) >= k and tdb.required_pad(k) % 8 == 0
