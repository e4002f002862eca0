"""The port's pyramid downsample against the JAX package's on the CPU, and a
fluid registration with a pyramid against JAX run op by op.

The JAX package computes the box mean in two forms (``reshape(...).mean()``
up to an extent of 4096, two box-matrix products above), and XLA on the CPU
adds each patch in an order that depends on the form and the shape. The
port's ``downsample_image`` follows those orders with a fixed sequence of
tensor adds. The images are the tiled pattern, which has no subnormal
values (XLA on the CPU flushes subnormals to zero, PyTorch keeps them).

Tolerances: the downsampled levels bit for bit; the registration 1e-5 px
with equal iteration and regrid counts, as ``test_torch_fluid.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import opticalflow2d_tpu as J
import opticalflow2d_tpu_torch as T
from _torch_helpers import DOWNSAMPLE_CASES, assert_close, npy, tiled_pair, tt
from opticalflow2d_tpu.ops.resample import downsample_image as j_downsample_image
from opticalflow2d_tpu_torch.interop import config_from_jax
from opticalflow2d_tpu_torch.ops.resample import downsample_image, pyramid_dims

EXACT = dict(warp_halo=0, warp_halo_outer=0, warp_halo_auto=False)

# (shape, level) -> pixels that differ from the JAX package, for each of
# iref and imov, the 2D images and the [2, nx, ny] stack of both: none at
# any of the cases (``_torch_helpers.DOWNSAMPLE_CASES``).
CASES = {case: (0, 0) for case in DOWNSAMPLE_CASES}


def _differing(x: np.ndarray, dims) -> int:
    """Pixels where the port's downsample of ``x`` differs from JAX's (run
    on a JAX array: given a numpy array, its mean form would run numpy's)."""
    got = npy(downsample_image(tt(x), dims))
    return int((got != np.asarray(j_downsample_image(jnp.asarray(x), dims))).sum())


@pytest.mark.parametrize("shape,level", list(CASES), ids=lambda v: str(v))
def test_downsample_matches_jax(shape, level):
    iref, imov = tiled_pair(*shape)
    dims = pyramid_dims(shape, level)[level]
    got = (_differing(iref, dims) + _differing(imov, dims),
           _differing(np.stack([iref, imov]), dims))
    assert got == CASES[shape, level]


def test_downsample_is_a_fixed_order_on_any_layout():
    """A non-contiguous input gives the same bits as a contiguous one: the
    sum is elementwise adds, not a reduction."""
    x = torch.from_numpy(np.random.default_rng(1).uniform(0.25, 4.0, (96, 128)).astype(np.float32))
    want = downsample_image(x, (48, 64))
    got = downsample_image(x.t().contiguous().t(), (48, 64))
    assert torch.equal(got, want)


@pytest.mark.parametrize("regrid_threshold", [0.5, 0.999])
def test_fluid_pyramid_matches_jax(regrid_threshold):
    """Fluid with one coarser level on the 256^2 tiled pair, JAX op by op:
    the coarse level's images come from the downsample, whose rounding the
    fluid timestep amplifies (6.65e-5 px before the port followed XLA's
    order)."""
    iref, imov = tiled_pair(256, 256)
    jcfg = J.RegConfig(method=J.Method.FLUID, niter=(8, 8), nscales=1, nrefine=2, mu=0.25,
                       lam=0.0, regrid_threshold=regrid_threshold, **EXACT)
    with jax.disable_jit():
        want = J.register(iref, imov, jcfg)
    got = T.register(tt(iref), tt(imov), config_from_jax(jcfg), device="cpu")
    assert [t.iterations for t in got.traces] == [int(t.iterations) for t in want.traces]
    assert [t.regrids for t in got.traces] == [int(t.regrids) for t in want.traces]
    assert sum(t.regrids for t in got.traces) > 0
    assert_close(got.motion, want.motion, 1e-5)
