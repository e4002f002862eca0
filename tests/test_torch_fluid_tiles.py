"""The Python side of the fluid iteration's tiles (CPU): the plan, the
shared memory it needs beside the sizes it was chosen against, and the
tile count the max partials are allocated by. The kernels themselves run
only on the card (``tests/test_torch_cuda.py``), where the C functions are
held against these mirrors.
"""

import pytest

from opticalflow2d_tpu_torch.kernels import fluid_fused as tff
from opticalflow2d_tpu_torch.kernels.demons_fused import MAX_SMEM_BYTES


def test_plan():
    assert tff.FLUID_PLAN == (32, 64, 512)
    assert tff.FLUID_HALO == 2


@pytest.mark.parametrize("plan,nbytes", [
    ((32, 64, 512), 4 * (9 * 36 * 68 + 16)),   # 88,192 B: two blocks an SM
    ((48, 48, 512), 4 * (9 * 52 * 52 + 16)),
    ((64, 32, 512), 4 * (9 * 68 * 36 + 16)),
    ((64, 64, 512), 4 * (9 * 68 * 68 + 16)),   # one block an SM
    ((32, 32, 256), 4 * (9 * 36 * 36 + 8)),    # the layout before the redesign
])
def test_bytes_per_plan(plan, nbytes):
    """u, the velocity twice and g, 9 planes of the tile extended by 2 a
    side, and one max per warp."""
    assert 4 * tff.fluid_smem_floats(*plan) == nbytes


def test_plan_holds_two_blocks_an_sm():
    nbytes = 4 * tff.fluid_smem_floats(*tff.FLUID_PLAN)
    assert nbytes == 88192 <= MAX_SMEM_BYTES
    assert 2 * (nbytes + 1024) <= 228 * 1024


@pytest.mark.parametrize("nx,ny,tiles", [
    (2, 2, 1),               # the smallest grid the kernels take
    (4, 4, 1),
    (33, 1000, 32),          # 2 x 16 tiles of 32 x 64
    (100, 77, 8),            # 4 x 2
    (25, 77, 2),             # a ragged 25-row strip
    (51, 777, 26),           # a strip of 1004 x 777 in 4: 2 x 13
    (1000, 777, 416),        # 32 x 13
    (1024, 4096, 2048),      # the timed strip: 32 x 64
    (4096, 4096, 8192),
    (16384, 16384, 131072),  # the fluid_16k level: 512 x 256
])
def test_partials_are_the_tile_count(nx, ny, tiles):
    tx, ty, _ = tff.FLUID_PLAN
    assert tff.fluid_tiles(nx, ny) == tiles == -(-nx // tx) * -(-ny // ty)


def test_strip_pad_holds_the_halo():
    """The strip driver pads 8 rows, the TPU kernel's _PAD; the sweep's cone
    needs FLUID_HALO."""
    assert tff.FLUID_PAD == 8 >= tff.FLUID_HALO
