"""The port's plain ops against ``opticalflow2d_tpu.ops`` and ``solvers`` on
the same numpy inputs (CPU).

Tolerance: 1e-6 absolute for values of order 1, the float32 rounding of a
few operations taken in another order (for example XLA's and PyTorch's
reduction orders). Warps and composes follow the same order of operations
and hold to 1e-6 at displacements of tens of pixels.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from _torch_helpers import assert_close, npy, tt
from conftest import make_pair

from opticalflow2d_tpu import metrics as jmetrics
from opticalflow2d_tpu.ops import grid as jgrid
from opticalflow2d_tpu.ops import reduce as jreduce
from opticalflow2d_tpu.ops import resample as jresample
from opticalflow2d_tpu.ops import warp as jwarp
from opticalflow2d_tpu.solvers import base as jbase
from opticalflow2d_tpu.solvers import diffusion as jdiffusion
from opticalflow2d_tpu_torch import metrics as tmetrics
from opticalflow2d_tpu_torch.ops import grid as tgrid
from opticalflow2d_tpu_torch.ops import reduce as treduce
from opticalflow2d_tpu_torch.ops import resample as tresample
from opticalflow2d_tpu_torch.ops import warp as twarp
from opticalflow2d_tpu_torch.solvers import base as tbase
from opticalflow2d_tpu_torch.solvers import diffusion as tdiffusion

TOL = 1e-6


def _field(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


@pytest.mark.parametrize("name", [
    "partial_x", "partial_y", "qlaplacian", "spatial_gradient", "jacobian_det",
])
@pytest.mark.parametrize("shape", [(2, 13, 11), (2, 4, 4)])
def test_grid_ops(name, shape, rng):
    f = _field(rng, shape)
    if name == "spatial_gradient":
        f = f[0]
    assert_close(getattr(tgrid, name)(tt(f)), getattr(jgrid, name)(jnp.asarray(f)), TOL)


@pytest.mark.parametrize("name,kw", [
    ("motion_norm", {}),
    ("motion_maxabs", {}),
    ("motion_maxabs", {"bug": True}),
    ("normalize_minmax", {}),
])
def test_reduce_ops(name, kw, rng):
    u = _field(rng, (2, 17, 9), 3.0)
    assert_close(getattr(treduce, name)(tt(u), **kw),
                 getattr(jreduce, name)(jnp.asarray(u), **kw), TOL, 1e-6)


def test_ssd_and_metrics(rng):
    iref, imov = make_pair(24, 20)
    u = _field(rng, (2, 24, 20), 2.0)
    v = _field(rng, (2, 24, 20), 2.0)
    assert_close(treduce.ssd(tt(iref), tt(imov)), jreduce.ssd(iref, imov), 0, 1e-6)
    assert_close(tmetrics.endpoint_error(tt(u), tt(v)),
                 jmetrics.endpoint_error(jnp.asarray(u), jnp.asarray(v)), TOL)
    assert_close(tmetrics.warped_ssd(tt(iref), tt(imov), tt(u)),
                 jmetrics.warped_ssd(iref, imov, u), 0, 1e-5)
    assert_close(tmetrics.ssd_reduction(tt(iref), tt(imov), tt(u)),
                 jmetrics.ssd_reduction(iref, imov, u), TOL)


@pytest.mark.parametrize("dims,nscales", [((64, 48), 3), ((37, 29), 2), ((1000, 777), 4)])
def test_pyramid_dims(dims, nscales):
    assert tresample.pyramid_dims(dims, nscales) == jresample.pyramid_dims(dims, nscales)


@pytest.mark.parametrize("src,dst", [((16, 12), (8, 6)), ((37, 29), (18, 14))])
def test_downsample(src, dst, rng):
    img = _field(rng, src)
    u = _field(rng, (2,) + src)
    assert_close(tresample.downsample_image(tt(img), dst),
                 jresample.downsample_image(jnp.asarray(img), dst), TOL)
    assert_close(tresample.downsample_motion(tt(u), dst),
                 jresample.downsample_motion(jnp.asarray(u), dst), TOL)


@pytest.mark.parametrize("src,dst", [((8, 6), (16, 12)), ((18, 14), (37, 29))])
def test_upsample(src, dst, rng):
    img = _field(rng, src)
    u = _field(rng, (2,) + src)
    assert_close(tresample.upsample_image(tt(img), dst),
                 jresample.upsample_image(jnp.asarray(img), dst), TOL)
    assert_close(tresample.upsample_motion(tt(u), dst),
                 jresample.upsample_motion(jnp.asarray(u), dst), TOL)


def test_resample_rejects_wrong_direction(rng):
    img = tt(_field(rng, (8, 8)))
    with pytest.raises(ValueError):
        tresample.downsample_image(img, (16, 16))
    with pytest.raises(ValueError):
        tresample.upsample_image(img, (4, 4))


@pytest.mark.parametrize("scale", [0.7, 5.0, 40.0])
@pytest.mark.parametrize("shape", [(24, 20), (31, 17)])
def test_warp_and_compose_match_exact_gather(scale, shape, rng):
    """Small, large and out-of-bounds displacements against the JAX exact
    gather (halo=0), including integer displacements that land on the
    last row and column."""
    iref, _ = make_pair(*shape)
    u = _field(rng, (2,) + shape, scale)
    u[:, ::5, ::3] = np.round(u[:, ::5, ::3])
    u_total = _field(rng, (2,) + shape, 3.0)
    assert_close(twarp.warp2d(tt(iref), tt(u)), jwarp.warp2d(iref, u, halo=0), TOL)
    assert_close(twarp.compose(tt(u_total), tt(u)),
                 jwarp.compose(jnp.asarray(u_total), jnp.asarray(u), halo=0), TOL * scale)


def test_warp_passes_out_of_bounds_through():
    img = np.arange(12, dtype=np.float32).reshape(4, 3)
    u = np.zeros((2, 4, 3), np.float32)
    u[0] = 10.0  # every sample lands below the last row
    assert_close(twarp.warp2d(tt(img), tt(u)), img, 0)
    total = np.ones((2, 4, 3), np.float32)
    assert_close(twarp.compose(tt(total), tt(u)), total, 0)


def test_derivatives_and_forces(rng):
    iref, imov = make_pair(20, 18)
    u = _field(rng, (2, 20, 18))
    jd = jbase.derivatives(jnp.asarray(iref), jnp.asarray(imov))
    td = tbase.derivatives(tt(iref), tt(imov))
    assert_close(td.grad_i, jd.grad_i, TOL)
    assert_close(td.it, jd.it, TOL)
    assert_close(tbase.lssd_force(td, tt(u)), jbase.lssd_force(jd, jnp.asarray(u)), TOL)
    # Flat, matched pixels (zero gradient and zero It) hit the 0/0 guard.
    flat = tbase.Derivatives(td.grad_i.clone(), td.it.clone())
    flat.grad_i[:, :3] = 0
    flat.it[:3] = 0
    jflat = jbase.Derivatives(jnp.asarray(npy(flat.grad_i)), jnp.asarray(npy(flat.it)))
    got = tbase.demons_force(flat, 1.0, 0.25)
    assert np.isfinite(npy(got)).all()
    assert_close(got, jbase.demons_force(jflat, 1.0, 0.25), TOL, 1e-6)


@pytest.mark.parametrize("alpha", [0.1, 1.0])
def test_plain_diffusion_step(alpha, rng):
    iref, imov = make_pair(20, 18)
    u = _field(rng, (2, 20, 18))
    jd = jbase.derivatives(jnp.asarray(iref), jnp.asarray(imov))
    td = tbase.derivatives(tt(iref), tt(imov))
    assert_close(tdiffusion.diffusion_step(tt(u), td, alpha),
                 jdiffusion.diffusion_step(jnp.asarray(u), jd, alpha), TOL, 1e-6)
