"""The motion upsample's wrapper (``kernels/upsample.py``) on the CPU: its
plain version against the JAX package, the ratios it rounds on the host,
the kernel's arithmetic emulated in numpy float32 against the plain version
bit for bit, and what it refuses. The kernel itself is compared on the card
(``tests/test_torch_cuda.py``).

Tolerance against JAX: 1e-6 absolute, as in ``test_torch_ops.py`` (the JAX
package reads its taps through selection matmuls).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from _torch_helpers import assert_close, npy, tt

from opticalflow2d_tpu.ops import resample as jresample
from opticalflow2d_tpu_torch import kernels
from opticalflow2d_tpu_torch.kernels.upsample import (
    upsample_motion, upsample_motion_ref, upsample_ratios)
from opticalflow2d_tpu_torch.ops import resample as tresample

TOL = 1e-6
# Odd and non-square shapes, one axis left as it is, and the cell's factor 2.
SHAPES = [((21, 17), (41, 33)), ((5, 7), (64, 48)), ((300, 1), (600, 7)),
          ((9, 9), (9, 20)), ((16, 16), (32, 32))]
# (n_in, n_out) of one axis: the cell's levels, the odd shapes above and a
# few ratios whose float32 rounding is not exact.
RATIOS = [(4096, 4096), (2048, 4096), (1024, 4096), (512, 4096), (256, 4096), (17, 41),
          (7, 48), (21, 41), (1, 7), (300, 600), (3, 10), (1000, 16384), (777, 1000)]


def _field(rng, shape):
    """A motion with negative values and exact zeros of both signs."""
    u = (rng.standard_normal((2,) + shape) * 3).astype(np.float32)
    u.flat[::5] = 0.0
    u.flat[1::7] = -0.0
    return u


def _bits(x) -> np.ndarray:
    return np.ascontiguousarray(npy(x), dtype=np.float32).view(np.int32)


@pytest.mark.parametrize("src,dst", SHAPES)
def test_cpu_wrapper_matches_jax(src, dst, rng):
    u = _field(rng, src)
    kernels.reset_launches()
    got = upsample_motion(tt(u), dst)
    assert got.shape == (2,) + dst
    assert_close(got, jresample.upsample_motion(jnp.asarray(u), dst), TOL)
    assert_close(tresample.upsample_motion(tt(u), dst), got, 0.0)
    assert kernels.LAUNCHES["upsample_motion"] == 0


@pytest.mark.parametrize("n_in,n_out", RATIOS)
def test_host_ratios_round_as_torch_tensor(n_in, n_out):
    rx, ry, sx, sy = upsample_ratios((n_in, 1), (n_out, 3))
    assert rx == torch.tensor(n_in / n_out, dtype=torch.float32).item()
    assert sx == torch.tensor(n_out / n_in, dtype=torch.float32).item()
    assert (ry, sy) == (torch.tensor(1 / 3, dtype=torch.float32).item(), 3.0)


def _kernel_emulated(u: np.ndarray, dst) -> np.ndarray:
    """``csrc/upsample.cu`` point by point in numpy float32: the host-rounded
    ratios, ``bilinear.cuh::bilinear_point``'s taps and weights in its order,
    all four taps multiplied, then ``/ weight * s_c``."""
    f = np.float32
    _, nx, ny = u.shape
    rx, ry, sx, sy = (f(r) for r in upsample_ratios((nx, ny), dst))
    px = np.arange(dst[0], dtype=f)[:, None] * rx
    py = np.arange(dst[1], dtype=f)[None, :] * ry
    px, py = np.broadcast_arrays(px, py)
    dxf, dyf = np.floor(px), np.floor(py)
    fx, fy = px - dxf, py - dyf
    dx, dy = dxf.astype(np.int64), dyf.astype(np.int64)
    has_x1, has_y1 = dx < nx - 1, dy < ny - 1
    one, zero = f(1), f(0)
    w00 = (one - fx) * (one - fy)
    w10 = np.where(has_x1, fx * (one - fy), zero)
    w01 = np.where(has_y1, (one - fx) * fy, zero)
    w11 = np.where(has_x1 & has_y1, fx * fy, zero)
    weight = w00 + w10 + w01 + w11
    x0, x1 = np.clip(dx, 0, nx - 1), np.clip(dx + 1, 0, nx - 1)
    y0, y1 = np.clip(dy, 0, ny - 1), np.clip(dy + 1, 0, ny - 1)
    out = []
    for c, s in ((0, sx), (1, sy)):
        d = u[c]
        value = d[x0, y0] * w00 + d[x1, y0] * w10 + d[x0, y1] * w01 + d[x1, y1] * w11
        out.append(value / np.where(weight != 0, weight, one) * s)
    return np.stack(out).astype(f)


@pytest.mark.parametrize("src,dst", SHAPES + [((256, 256), (4096, 512))])
def test_kernel_arithmetic_equals_plain_bit_for_bit(src, dst, rng):
    u = _field(rng, src)
    want = upsample_motion_ref(tt(u), dst)
    np.testing.assert_array_equal(_bits(_kernel_emulated(u, dst)), _bits(want))


def test_wrapper_rejects_a_target_below_the_source(rng):
    u = tt(_field(rng, (8, 8)))
    for dst in ((4, 8), (8, 4), (4, 4)):
        with pytest.raises(ValueError, match="below source"):
            upsample_motion(u, dst)
