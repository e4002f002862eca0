"""The port's demons ops and kernels' plain versions against the JAX package
on the same numpy inputs (CPU).

- ``ops/conv.py`` against JAX ``ops/conv.py``: the same taps in the same
  order, so 1e-6 max-abs for values of order 1.
- ``expmap`` against JAX ``expmap`` (its exact gather, halo 0), with the
  squaring count at and near powers of two.
- Each demons kernel's plain version against the JAX Pallas kernel run in
  interpret mode: fields 1e-5 max-abs, Logger sums 1e-5 relative (added in
  another order).
- ``make_demons_step`` against JAX's jnp step for every route, over three
  iterations: fields 1e-5 max-abs, and bit for bit where no exp map
  squares (JAX compiles its squaring loop, whose fused bilinear sums round
  apart by about 1e-7), sums 1e-5 relative.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from _torch_helpers import assert_close, tt
from conftest import make_pair

from opticalflow2d_tpu.ops import conv as jconv
from opticalflow2d_tpu.ops import warp as jwarp
from opticalflow2d_tpu.pallas_kernels.demons_fused import (
    compose_smooth_pallas, demons_correspondence_pallas)
from opticalflow2d_tpu.pallas_kernels.demons_onepass import thirion_onepass_pallas
from opticalflow2d_tpu.pallas_kernels.logger_norms import logger_norms_pallas
from opticalflow2d_tpu.solvers import demons as jdemons
from opticalflow2d_tpu_torch import MotionAccumulation, kernels
from opticalflow2d_tpu_torch.kernels import demons_fused as tfused
from opticalflow2d_tpu_torch.kernels import demons_onepass as tonepass
from opticalflow2d_tpu_torch.kernels.logger_norms import logger_norms, logger_norms_ref
from opticalflow2d_tpu_torch.ops import conv as tconv
from opticalflow2d_tpu_torch.ops import warp as twarp
from opticalflow2d_tpu_torch.solvers import demons as tdemons

TOL = 1e-6
KERNEL_TOL = 1e-5
SUMS_RTOL = 1e-5


def _field(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _demons_inputs(rng, nx=64, ny=48):
    """Random images and a motion field within the TPU kernels' halo of 2."""
    iaux = rng.random((nx, ny)).astype(np.float32)
    iref = rng.random((nx, ny)).astype(np.float32)
    u = (np.tanh(rng.standard_normal((2, nx, ny))) * 1.8).astype(np.float32)
    return iaux, iref, u


@pytest.mark.parametrize("shape,sigma,kw", [
    ((2, 24, 20), 2.0, 5), ((2, 17, 13), 1.0, 3), ((31, 9), 3.0, 7), ((2, 12, 16), 0.7, 11),
])
def test_convolve2d_clip(shape, sigma, kw, rng):
    f = _field(rng, shape)
    assert_close(tconv.convolve2d_clip(tt(f), sigma, kw),
                 jconv.convolve2d_clip(jnp.asarray(f), sigma, kw), TOL)
    assert_close(tconv.gaussian_smooth(tt(f), sigma, kw),
                 jconv.gaussian_smooth(jnp.asarray(f), sigma, kw), TOL)


@pytest.mark.parametrize("shape,sigma,kw", [((2, 13, 11), 2.0, 5), ((9, 14), 1.0, 3)])
def test_convolve2d_flatwrap(shape, sigma, kw, rng):
    f = _field(rng, shape)
    assert_close(tconv.gaussian_smooth(tt(f), sigma, kw, flatwrap=True),
                 jconv.convolve2d_flatwrap(jnp.asarray(f), sigma, kw), TOL)


def test_kernels_and_dense_convolution(rng):
    for sigma, width in ((2.0, 5), (0.5, 3), (1.7, 9)):
        np.testing.assert_array_equal(tconv.gaussian_kernel_1d(sigma, width),
                                      jconv.gaussian_kernel_1d(sigma, width))
        np.testing.assert_array_equal(tconv.gaussian_kernel_2d(sigma, width),
                                      jconv.gaussian_kernel_2d(sigma, width))
    np.testing.assert_array_equal(tconv.box_kernel_2d(3), jconv.box_kernel_2d(3))
    f = _field(rng, (2, 15, 12))
    for k2d in (jconv.box_kernel_2d(3), jconv.gaussian_kernel_2d(1.0, 5)[:, 1:4]):
        assert_close(tconv.convolve2d_kernel(tt(f), k2d),
                     jconv.convolve2d_kernel(jnp.asarray(f), k2d), TOL)


def _point_field(value, channel=0, shape=(2, 12, 10)):
    u = np.zeros(shape, np.float32)
    u[channel, 4, 5] = value
    u[1 - channel, 7, 2] = value / 4
    return u


@pytest.mark.parametrize("m", [0.0, 0.5, 1.0, 2.0, 3.7])
@pytest.mark.parametrize("bug", [False, True])
def test_expmap_matches_jax(m, bug, rng):
    """Fields whose (buggy) maxabs is exactly 0, 0.5, 1, 2 or between, plus
    a smooth random field: the squaring counts 0, 0, 1, 2 and 3 of the
    reference's formula, and the squarings as JAX's exact compose."""
    u = _point_field(m, channel=1 if bug else 0)
    if m == 3.7:
        u = _field(rng, (2, 12, 10), 1.3)
    want = jwarp.expmap(jnp.asarray(u), maxabs_bug=bug)
    assert_close(twarp.expmap(tt(u), maxabs_bug=bug), want, TOL)


def test_expmap_squaring_count_near_powers_of_two(rng):
    """The count from one host read of ``m`` against JAX's float32 formula,
    at powers of two, one ulp either side, and random values."""
    pows = np.float32(2.0) ** np.arange(-1, 7, dtype=np.float32)
    ms = np.concatenate([pows, np.nextafter(pows, np.float32(0)),
                         np.nextafter(pows, np.float32(1e9)),
                         rng.uniform(0, 20, 2000).astype(np.float32),
                         np.float32([0.0, 1e-30])])
    mj = jnp.asarray(ms)
    want = jnp.maximum(jnp.ceil(1.0 + jnp.log2(jnp.maximum(mj, jnp.finfo(jnp.float32).tiny))),
                       0.0).astype(jnp.int32)
    want = np.where(ms > 0, np.asarray(want), 0)
    assert [twarp.expmap_nsq(float(v)) for v in ms] == want.tolist()
    for bound in (0.0, 0.125, 0.5, 0.5001, 1.0, 2.0, 3.0):
        assert twarp.static_expmap_nsq(bound) == jwarp.static_expmap_nsq(bound)


@pytest.mark.parametrize("addition,kw,with_errors", [
    (False, 5, True), (False, 7, False), (True, 5, True), (True, 5, False),
])
def test_onepass_ref_matches_pallas(addition, kw, with_errors, rng):
    iaux, iref, u = _demons_inputs(rng)
    with pltpu.force_tpu_interpret_mode():
        want = thirion_onepass_pallas(jnp.asarray(iaux), jnp.asarray(iref), jnp.asarray(u),
                                      1.0, 0.25, 2.0, 1.7, kw, halo=2, addition=addition,
                                      with_errors=with_errors)
    got = tonepass.thirion_onepass_ref(tt(iaux), tt(iref), tt(u), 1.0, 0.25, 2.0, 1.7, kw,
                                       addition, with_errors)
    if with_errors:
        (got, sums), (want, want_sums) = got, want
        assert_close(sums, want_sums, 0, SUMS_RTOL)
    assert_close(got, want, KERNEL_TOL)


@pytest.mark.parametrize("shape", [(64, 48), (60, 48)])
def test_correspondence_ref_matches_pallas(shape, rng):
    iaux, iref, u = _demons_inputs(rng, *shape)
    with pltpu.force_tpu_interpret_mode():
        want = demons_correspondence_pallas(jnp.asarray(iaux), jnp.asarray(iref),
                                            jnp.asarray(u), 1.0, 0.25, 2.0, 5, halo=2)
    got = tfused.demons_correspondence_ref(tt(iaux), tt(iref), tt(u), 1.0, 0.25, 2.0, 5)
    assert_close(got, want, KERNEL_TOL)


@pytest.mark.parametrize("kw", [5, 7])
def test_compose_smooth_ref_matches_pallas(kw, rng):
    u = np.clip(2.0 * rng.standard_normal((2, 64, 48)), -4, 4).astype(np.float32)
    c = np.clip(rng.standard_normal((2, 64, 48)), -1.9, 1.9).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = compose_smooth_pallas(jnp.asarray(u), jnp.asarray(c), 2.0, kw, halo=2)
    assert_close(tfused.compose_smooth_ref(tt(u), tt(c), 2.0, kw), want, KERNEL_TOL)


@pytest.mark.parametrize("shape", [(64, 48), (16, 37)])
def test_logger_norms_ref_matches_pallas(shape, rng):
    u_new = _field(rng, (2,) + shape, 2.0)
    u_prev = _field(rng, (2,) + shape, 2.0)
    with pltpu.force_tpu_interpret_mode():
        want = logger_norms_pallas(jnp.asarray(u_new), jnp.asarray(u_prev))
    got = logger_norms_ref(tt(u_new), tt(u_prev))
    assert got.shape == (2,)
    assert_close(got, want, 0, SUMS_RTOL)
    assert_close(tdemons.logger_sums(tt(u_new), tt(u_prev)),
                 jdemons.logger_sums(jnp.asarray(u_new), jnp.asarray(u_prev)), 0, SUMS_RTOL)


# (route, make_demons_step keywords, Thirion by addition): every route the
# port takes.
STEPS = {
    "onepass_composition": ("onepass", dict(diffeomorphic=False), False),
    "onepass_addition": ("onepass", dict(diffeomorphic=False), True),
    "onepass_diffeomorphic": ("onepass", dict(diffeomorphic=True), False),
    "two_kernel": ("two_kernel", dict(diffeomorphic=True, sigma_i=0.25, sigma_x=1.0), False),
    "two_kernel_maxabs_bug": ("two_kernel", dict(diffeomorphic=True, maxabs_bug=True), False),
    "op_chain_flatwrap": ("op_chain", dict(diffeomorphic=False, conv_flatwrap=True), False),
    "op_chain_wide_kernel": ("op_chain", dict(diffeomorphic=True, sigma_i=0.25, sigma_x=1.0,
                                              kernelwidth=45), False),
}


@pytest.mark.parametrize("name", list(STEPS))
def test_demons_step_matches_jax_jnp(name, rng):
    route, kw, addition = STEPS[name]
    params = dict(sigma_i=1.0, sigma_x=0.25, sigma_diffusion=2.0, sigma_fluid=2.0,
                  kernelwidth=5)
    params.update(kw)
    assert tdemons.demons_route(params["sigma_i"], params["sigma_x"], params["kernelwidth"],
                                params["diffeomorphic"], params.get("conv_flatwrap", False),
                                params.get("maxabs_bug", False)) == route
    jstep = jdemons.make_demons_step(
        with_errors=True, accumulation=jdemons.MotionAccumulation(int(addition)), **params)
    tstep = tdemons.make_demons_step(
        with_errors=True, accumulation=MotionAccumulation(int(addition)), **params)
    iref, imov = make_pair(40, 36, shift=(1.3, -0.8))
    u = rng.uniform(-1.5, 1.5, (2, 40, 36)).astype(np.float32)
    ju, tu = jnp.asarray(u), tt(u)
    for _ in range(3):
        ju, jsums = jstep(ju, jnp.asarray(iref), jnp.asarray(imov))
        tu, tsums = tstep(tu, tt(iref), tt(imov))
        assert_close(tsums, jsums, 0, SUMS_RTOL)
    assert_close(tu, ju, KERNEL_TOL)
    if not params["diffeomorphic"] or route == "onepass":  # no squaring loop
        assert torch.equal(tu, tt(ju))


def test_routes_and_tile_fit():
    """The route comes from the configuration alone; kernelwidth 43 is the
    widest whose one-pass tile fits an H100 block's shared memory."""
    assert tonepass.tile_fits(43) and not tonepass.tile_fits(45)
    assert tonepass.onepass_smem_bytes(5) == 4 * (2 * 42 * 42 + 2 * 40 * 40 + 16)
    assert tfused.correspondence_smem_bytes(5) <= tonepass.onepass_smem_bytes(5)
    assert tfused.compose_smooth_smem_bytes(5) <= tonepass.onepass_smem_bytes(5)
    assert tdemons.expmap_identity_regime(1.0, 0.25)
    assert not tdemons.expmap_identity_regime(1.0, 0.25, maxabs_bug=True)
    assert not tdemons.expmap_identity_regime(0.25, 1.0)
    for si, sx in ((1.0, 0.25), (0.25, 1.0), (1.0, 1.0), (0.0, 1.0)):
        assert tdemons.expmap_identity_regime(si, sx) == jdemons.expmap_identity_regime(si, sx)


def test_wrappers_take_the_plain_version_on_cpu(rng):
    iaux, iref, u = (tt(a) for a in _demons_inputs(rng, 24, 20))
    before = dict(kernels.LAUNCHES)
    got, sums = tonepass.thirion_onepass(iaux, iref, u, 1.0, 0.25, 2.0, 2.0, 5,
                                         with_errors=True)
    want, want_sums = tonepass.thirion_onepass_ref(iaux, iref, u, 1.0, 0.25, 2.0, 2.0, 5,
                                                   with_errors=True)
    assert torch.equal(got, want) and torch.equal(sums, want_sums)
    c = tfused.demons_correspondence(iaux, iref, u, 1.0, 0.25, 2.0, 5)
    assert torch.equal(c, tfused.demons_correspondence_ref(iaux, iref, u, 1.0, 0.25, 2.0, 5))
    assert torch.equal(tfused.compose_smooth(u, c, 2.0, 5),
                       tfused.compose_smooth_ref(u, c, 2.0, 5))
    assert torch.equal(logger_norms(u, c), logger_norms_ref(u, c))
    assert kernels.LAUNCHES == before  # no kernel ran


@pytest.mark.parametrize("mixed", [False, True])
def test_wrappers_raise_on_other_devices(mixed):
    u = torch.zeros((2, 8, 8), device="meta")
    img = torch.zeros((8, 8), device="cpu" if mixed else "meta")
    with pytest.raises(ValueError):
        tonepass.thirion_onepass(img, img, u, 1.0, 0.25, 2.0, 2.0, 5)
    with pytest.raises(ValueError):
        tfused.demons_correspondence(img, img, u, 1.0, 0.25, 2.0, 5)
    with pytest.raises(ValueError):
        tfused.compose_smooth(u, torch.zeros((2, 8, 8), device=img.device), 2.0, 5)
    with pytest.raises(ValueError):
        logger_norms(u, torch.zeros((2, 8, 8), device=img.device))
