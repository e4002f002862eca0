"""The Python side of the elastic block's tiles (CPU): the plan list, the
shared memory each plan needs at each k, the plan a launch takes, and the
tile count the Logger partials are allocated by. The kernel itself runs only
on the card (``tests/test_torch_cuda.py``), where the C functions are held
against these mirrors.
"""

import pytest

from opticalflow2d_tpu_torch.kernels import elastic_block as tel
from opticalflow2d_tpu_torch.kernels.demons_fused import MAX_SMEM_BYTES

WIDEST = 14  # the largest k whose block fits an H100 thread block


def test_plan_list_in_order_of_preference():
    assert tel.ELASTIC_PLANS == ((48, 48, 512), (32, 32, 256))


@pytest.mark.parametrize("k,plan,nbytes", [
    (1, (48, 48, 512), 4 * (7 * 52 * 52 + 1 * 16 * 2)),
    (4, (48, 48, 512), 4 * (7 * 64 * 64 + 4 * 16 * 2)),   # 115,200 B: two blocks an SM
    (10, (48, 48, 512), 4 * (7 * 88 * 88 + 10 * 16 * 2)),
    (4, (32, 32, 256), 4 * (7 * 48 * 48 + 4 * 8 * 2)),    # the layout before the redesign
    (11, (32, 32, 256), 4 * (7 * 76 * 76 + 11 * 8 * 2)),
    (14, (32, 32, 256), 4 * (7 * 88 * 88 + 14 * 8 * 2)),
])
def test_bytes_per_plan_and_k(k, plan, nbytes):
    """u twice and g, 7 planes of the tile extended by 2k a side, and the
    warps' Logger partials of each iteration."""
    assert 4 * tel.elastic_smem_floats(k, *plan) == nbytes


def test_main_k_takes_48_tiles_two_blocks_an_sm():
    """k = 4 on 48 x 48: two blocks fit an SM's 228 KiB with their 1 KiB
    reservations."""
    assert tel.elastic_smem_bytes(4) == 115200 <= MAX_SMEM_BYTES
    assert tel.elastic_plan(4) == (48, 48, 512)
    assert 2 * (115200 + 1024) <= 228 * 1024


@pytest.mark.parametrize("k", range(1, WIDEST + 1))
def test_each_k_takes_the_first_plan_that_fits(k):
    """k 1-10 on 48 x 48 (1-4 compiled in, 5-10 at run time), 11-14 on
    32 x 32."""
    p = tel.elastic_plan(k)
    earlier = tel.ELASTIC_PLANS[:tel.ELASTIC_PLANS.index(p)]
    assert 4 * tel.elastic_smem_floats(k, *p) <= MAX_SMEM_BYTES
    assert all(4 * tel.elastic_smem_floats(k, *q) > MAX_SMEM_BYTES for q in earlier)
    assert p == ((48, 48, 512) if k <= 10 else (32, 32, 256))
    assert tel.elastic_smem_bytes(k) == 4 * tel.elastic_smem_floats(k, *p)


def test_k_above_14_is_refused():
    """k = 16 fits no plan: the wrapper's shared-memory check raises."""
    assert [k for k in range(1, 33) if tel.elastic_plan(k)] == list(range(1, WIDEST + 1))
    for k in (15, 16):
        assert tel.elastic_plan(k) is None
        assert tel.elastic_smem_bytes(k) > MAX_SMEM_BYTES
    assert tel.elastic_smem_bytes(16) == 4 * (7 * 96 * 96 + 16 * 8 * 2)


@pytest.mark.parametrize("nx,ny,k,tiles", [
    (4, 4, 4, 1),            # one tile, all border
    (4, 4, 12, 1),
    (33, 1000, 4, 21),       # 1 x 21 tiles of 48 x 48
    (33, 1000, 12, 64),      # 2 x 32 tiles of 32 x 32
    (100, 77, 4, 6),         # 3 x 2
    (100, 77, 11, 12),       # 4 x 3
    (25, 77, 4, 2),          # a ragged 25-row strip: 1 x 2
    (25, 4096, 2, 86),
    (1024, 4096, 4, 1892),   # the timed strip: 22 x 86
    (4096, 4096, 4, 7396),
])
def test_partials_rows_are_the_tile_count(nx, ny, k, tiles):
    tx, ty, _ = tel.elastic_plan(k)
    assert tel.elastic_tiles(nx, ny, k) == tiles == -(-nx // tx) * -(-ny // ty)
