"""The Python side of the demons kernels' tiles (CPU): which kernelwidths
the kernels take, the shared memory each layout needs, and the tile count
the Logger partials are allocated by. The kernels themselves run only on
the card (``tests/test_torch_cuda.py``), where the C functions are held
against these mirrors.
"""

import pytest

from opticalflow2d_tpu_torch.kernels import demons_fused as tfused
from opticalflow2d_tpu_torch.kernels import demons_onepass as tonepass

WIDEST = 43  # the widest kernelwidth whose B10 tile fits an H100 thread block


def test_tile_fits_takes_exactly_the_widths_up_to_43():
    assert [kw for kw in range(1, 65) if tonepass.tile_fits(kw)] == list(range(1, WIDEST + 1))


def test_every_layout_fits_wherever_tile_fits():
    for kw in range(1, WIDEST + 1):
        for smem in (tonepass.onepass_smem_bytes, tfused.correspondence_smem_bytes,
                     tfused.compose_smooth_smem_bytes):
            assert smem(kw) <= tfused.MAX_SMEM_BYTES, (smem.__name__, kw)
    for kw in range(WIDEST + 1, 65):
        assert tonepass.onepass_smem_bytes(kw) > tfused.MAX_SMEM_BYTES


@pytest.mark.parametrize("kernel", ["onepass", "correspondence"])
def test_each_plan_is_the_first_that_fits(kernel):
    """A kernelwidth takes the 64 x 64 tile with two staging buffers where
    it fits, else 32 x 32 with two, else with one."""
    floats = {"onepass": tonepass.onepass_smem_floats,
              "correspondence": tfused.correspondence_smem_floats}[kernel]
    plan = {"onepass": tonepass.onepass_plan, "correspondence": tfused.correspondence_plan}[kernel]
    assert tfused.PLANS == ((64, 64, 2), (32, 32, 2), (32, 32, 1))
    for kw in range(1, WIDEST + 1):
        p = plan(kw)
        earlier = tfused.PLANS[:tfused.PLANS.index(p)]
        assert 4 * floats(kw, *p) <= tfused.MAX_SMEM_BYTES
        assert all(4 * floats(kw, *q) > tfused.MAX_SMEM_BYTES for q in earlier), (kw, p)
    assert plan(5) == (64, 64, 2)


def test_onepass_layout_at_the_main_width():
    """kw 5 on 64 x 64 with two buffers: u (2 planes, 74^2) and iref (72^2)
    staged twice, work buffers of the sigma_f x pass (2 x 68 x 72) and corr
    (2 x 72^2), and 16 warps' Logger partials."""
    assert tonepass.onepass_smem_bytes(5) == 4 * (2 * (2 * 74 * 74 + 72 * 72) + 2 * 68 * 72
                                                  + 2 * 72 * 72 + 2 * 16)
    assert tfused.correspondence_smem_bytes(5) == 4 * (2 * (2 * 70 * 70 + 68 * 68) + 2 * 64 * 68
                                                       + 2 * 68 * 68)


@pytest.mark.parametrize("nx,ny,kw,tiles", [
    (4, 4, 5, 1),            # one tile, all border
    (33, 1000, 5, 16),       # 1 x 16 tiles of 64 x 64
    (33, 1000, 43, 64),      # 2 x 32 tiles of 32 x 32
    (250, 4096, 5, 256),     # a ragged strip of 250 rows: 4 x 64
    (250, 777, 11, 200),     # 8 x 25 tiles of 32 x 32
    (4096, 4096, 5, 4096),
    (1000, 777, 7, 208),     # 16 x 13
])
def test_partials_rows_are_the_tile_count(nx, ny, kw, tiles):
    tx, ty, _ = tonepass.onepass_plan(kw)
    assert tonepass.onepass_tiles(nx, ny, kw) == tiles == -(-nx // tx) * -(-ny // ty)
