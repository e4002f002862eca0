"""The box downsample's wrapper (``kernels/downsample.py``) on the CPU: the
kernel's arithmetic emulated in numpy float32 from the very arguments the
wrapper passes to ``csrc/downsample.cu`` (order, factors, partial sums,
host-rounded factors and ratios), held to the plain version bit for bit at
every case of ``_torch_helpers.DOWNSAMPLE_CASES``, 2D and stacked, image and
motion; the host-rounded ratios against ``_motion_ratio``; what it refuses.
The kernel itself is compared on the card (``tests/test_torch_cuda.py``).
"""

import numpy as np
import pytest
import torch

from _torch_helpers import DOWNSAMPLE_CASES, npy, tiled_pair, tt
from opticalflow2d_tpu_torch import kernels
from opticalflow2d_tpu_torch.kernels import downsample as k_down
from opticalflow2d_tpu_torch.ops.resample import (
    _motion_ratio, downsample_image, downsample_motion, pyramid_dims)

# Ragged crops (1000 x 777: every level crops a row or a column) and a 2 x 2
# patch on a width that is no power of two (100 x 77), beside the cases.
ODD_CASES = [((1000, 777), level) for level in range(1, 6)] + [((100, 77), 1), ((100, 77), 3)]


def _kernel_emulated(x: np.ndarray, dims, scales=(1.0, 1.0)) -> np.ndarray:
    """``csrc/downsample.cu`` in numpy float32 on every output at once, from
    ``kernel_args``: the patch's terms added in the order its form names,
    into its partial sums, then the scale of each plane."""
    f = np.float32
    (planes, nx_in, ny_in, nx_out, ny_out, fx, fy, form, n_a, n_b, sx, sy, inv, s0,
     s1) = k_down.kernel_args(x.shape, dims, scales)
    xs = x.reshape(planes, nx_in, ny_in)

    def at(a, b):
        return xs[:, a:nx_out * fx:fx, b:ny_out * fy:fy]

    def interleaved(term, n, n_acc):
        acc = []
        for r in range(min(n_acc, n)):
            s = term(r)
            for k in range(r + n_acc, n, n_acc):
                s = s + term(k)
            acc.append(s)
        if len(acc) == 1:
            return acc[0]
        if len(acc) == 2:
            return acc[0] + acc[1]
        if len(acc) == 3:
            return (acc[0] + acc[1]) + acc[2]
        return (acc[0] + acc[1]) + (acc[2] + acc[3])

    if form == k_down.PRODUCTS:
        v = interleaved(lambda b: interleaved(lambda a: at(a, b) * f(sx), fx, n_a) * f(sy),
                        fy, n_b)
    elif form == k_down.MEAN_PAIRS:
        v = at(0, 0) + at(0, 1)
        v = v + (at(1, 0) + at(1, 1))
        v = v * f(inv)
    else:
        v = at(0, 0)
        for a in range(fx):
            for b in range(1 if a == 0 else 0, fy):
                v = v + at(a, b)
        v = v * f(inv)
    scale = np.array([s0] + [s1] * (planes - 1), dtype=f)[:, None, None]
    return (v * scale).astype(f).reshape(x.shape[:-2] + tuple(dims))


def _bits(x) -> np.ndarray:
    return np.ascontiguousarray(npy(x), dtype=np.float32).view(np.int32)


@pytest.mark.parametrize("shape,level", DOWNSAMPLE_CASES + ODD_CASES, ids=lambda v: str(v))
def test_kernel_arithmetic_equals_plain_bit_for_bit(shape, level):
    iref, imov = tiled_pair(*shape)
    stack = np.stack([iref, imov])
    dims = pyramid_dims(shape, level)[level]
    kernels.reset_launches()
    for x in (iref, imov, stack):
        np.testing.assert_array_equal(_bits(_kernel_emulated(x, dims)),
                                      _bits(downsample_image(tt(x), dims)))
    ratios = k_down.motion_ratios(shape, dims)
    np.testing.assert_array_equal(_bits(_kernel_emulated(stack, dims, ratios)),
                                  _bits(downsample_motion(tt(stack), dims)))
    assert kernels.LAUNCHES["downsample"] == 0


def test_orders_follow_the_shape():
    """Up to 4096 ``box_mean``'s order (its pairs on a 2 x 2 patch of a
    power-of-two width), past it the box products' with the accumulators of
    the input's own shape: 2D and stacks differ."""
    order = k_down.downsample_order
    assert order((4096, 4096), (2048, 2048)) == (2, 2, k_down.MEAN_PAIRS, 1, 1)
    assert order((100, 77), (50, 38)) == (2, 2, k_down.MEAN, 1, 1)
    assert order((4096, 4096), (256, 256)) == (16, 16, k_down.MEAN, 1, 1)
    assert order((16384, 16384), (1024, 1024)) == (16, 16, k_down.PRODUCTS, 1, 1)
    assert order((8224, 32), (4112, 16)) == (2, 2, k_down.PRODUCTS, 2, 4)
    assert order((2, 8224, 32), (4112, 16)) == (2, 2, k_down.PRODUCTS, 4, 4)
    assert order((2, 16384, 16384), (2048, 2048)) == (8, 8, k_down.PRODUCTS, 1, 1)


@pytest.mark.parametrize("shape,level", [((4096, 4096), 1), ((4096, 4096), 3),
                                         ((16384, 16384), 2), ((1000, 777), 3),
                                         ((1000, 777), 5), ((37, 29), 2)])
def test_host_ratios_equal_motion_ratio(shape, level):
    dims = pyramid_dims(shape, level)[level]
    u = torch.zeros(()).expand((2,) + shape)  # the shape alone, no memory
    want = _motion_ratio(u, dims).flatten().tolist()
    assert list(k_down.motion_ratios(shape, dims)) == want


def test_host_factors_round_as_torch_does():
    """``1/fx`` and ``1/fy`` as float32 (a product with a Python float), and
    ``1/(fx fy)`` as the float32 reciprocal of the float32 size."""
    sx, sy, inv = k_down.downsample_factors(k_down.Order(3, 66, k_down.MEAN, 1, 1))
    assert sx == torch.tensor(1 / 3, dtype=torch.float32).item()
    assert sy == torch.tensor(1 / 66, dtype=torch.float32).item()
    assert inv == (torch.ones((), dtype=torch.float32) / 198).item()


def test_wrapper_rejects_a_target_above_the_source():
    x = tt(tiled_pair(8, 8)[0])
    for dst in ((16, 8), (8, 16)):
        with pytest.raises(ValueError, match="exceed"):
            downsample_image(x, dst)
    with pytest.raises(ValueError, match="exceed"):
        k_down.kernel_args((2, 8, 8), (4, 9))
