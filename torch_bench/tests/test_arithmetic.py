"""The generators, the percentile and B1's bytes."""

import pytest
import torch

from torch_bench import stats
from torch_bench.data import nuclei_texture
from torch_bench.rooflines import diffusion_block as b1


def _pool(data, dims, seed):
    return nuclei_texture.make_pool(data, dims, 4, seed, torch.device("cpu"))


def test_generators_repeat_for_a_seed(small_cell):
    _, _, config, _ = small_cell("slide_hs_4096.pair")
    dims = tuple(config["dims"])
    a = _pool(config["data"], dims, 2 ** 31 + 5)
    b = _pool(config["data"], dims, 2 ** 31 + 5)
    c = _pool(config["data"], dims, 2 ** 31 + 6)
    for (ra, ma), (rb, mb) in zip(a, b):
        assert ra.shape == dims and ra.dtype == torch.float32
        assert torch.equal(ra, rb) and torch.equal(ma, mb)
        assert float(ra.min()) == 0.0 and float(ra.max()) == 1.0
        assert not torch.equal(ra, ma)
    assert not torch.equal(a[0][0], c[0][0])


def test_percentile_of_a_known_list():
    xs = list(range(1, 101))  # 1 .. 100
    assert stats.percentile(xs, 90) == pytest.approx(90.1, abs=1e-12)
    assert stats.percentile(xs, 50) == 50.5
    assert stats.percentile([3.0], 90) == 3.0
    assert stats.percentile([4.0, 1.0, 3.0, 2.0], 100) == 4.0
    assert stats.percentile([4.0, 1.0, 3.0, 2.0], 0) == 1.0


def test_b1_bytes_match_the_kernel_table():
    # One launch at 4096^2 moves 28 B/px: 0.140 ms at 3.35 TB/s (PERF.md's
    # kernel table, B1's bound).
    one = b1.least_seconds([(0, 8, 0)], (4096, 4096), 0, 8, 3.35e12)
    assert abs(one * 1e3 - 0.140) < 0.0005
    # A solve of 400 iterations at k = 8 is 50 launches; 401 is 51.
    assert b1.launches(400, 8) == 50 and b1.launches(401, 8) == 51
    solves = [(1, 400, 0), (0, 19, 0)]
    assert b1.bytes_moved(solves, (4096, 4096), 1, 8) == 28 * (50 * 2048 ** 2 + 3 * 4096 ** 2)

