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


@pytest.mark.parametrize("kernel", ["onepass", "correspondence", "compose"])
def test_each_plan_is_the_first_that_fits(kernel):
    """A kernelwidth takes the 64 x 64 tile with two staging buffers where
    it fits, else 32 x 32 with two, else with one; B12 the 64 x 64 tile with
    one buffer, else 32 x 32 with one."""
    floats = {"onepass": tonepass.onepass_smem_floats,
              "correspondence": tfused.correspondence_smem_floats,
              "compose": tfused.compose_smooth_smem_floats}[kernel]
    plan = {"onepass": tonepass.onepass_plan, "correspondence": tfused.correspondence_plan,
            "compose": tfused.compose_smooth_plan}[kernel]
    plans = tfused.COMPOSE_PLANS if kernel == "compose" else tfused.PLANS
    assert tfused.PLANS == ((64, 64, 2), (32, 32, 2), (32, 32, 1))
    assert tfused.COMPOSE_PLANS == ((64, 64, 1), (32, 32, 1))
    for kw in range(1, WIDEST + 1):
        p = plan(kw)
        earlier = plans[:plans.index(p)]
        assert 4 * floats(kw, *p) <= tfused.MAX_SMEM_BYTES
        assert all(4 * floats(kw, *q) > tfused.MAX_SMEM_BYTES for q in earlier), (kw, p)
    assert plan(5) == plans[0]


def test_onepass_layout_at_the_main_width():
    """kw 5 on 64 x 64 with two buffers: u (2 planes, 74^2) and iref (72^2)
    staged twice, work buffers of the sigma_f x pass (2 x 68 x 72) and corr
    (2 x 72^2), and 16 warps' Logger partials."""
    assert tonepass.onepass_smem_bytes(5) == 4 * (2 * (2 * 74 * 74 + 72 * 72) + 2 * 68 * 72
                                                  + 2 * 72 * 72 + 2 * 16)
    assert tfused.correspondence_smem_bytes(5) == 4 * (2 * (2 * 70 * 70 + 68 * 68) + 2 * 64 * 68
                                                       + 2 * 68 * 68)


def test_compose_smooth_layout_at_the_main_width():
    """B12 at kw 5 on 64 x 64 with one buffer: c's two planes on the tile
    +- 2 (68^2) and the composed field (2 x 68^2); two such blocks fit an
    SM's 228 KiB with their 1 KiB reservations. 64 x 64 holds to kw 57;
    wider widths a Taps holds (to 63) take 32 x 32."""
    assert tfused.compose_smooth_smem_bytes(5) == 4 * 2 * 2 * 68 * 68 == 73984
    assert 2 * (73984 + 1024) <= 228 * 1024
    assert [kw for kw in range(1, 64, 2)
            if tfused.compose_smooth_plan(kw) == (64, 64, 1)] == list(range(1, 58, 2))
    assert all(tfused.compose_smooth_plan(kw) == (32, 32, 1) for kw in range(59, 64, 2))
    assert tfused.compose_smooth_smem_bytes(43) == 4 * 2 * 2 * 106 * 106


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
