"""The port's elastic solver, its block kernel's plain version and the elastic
registration against the JAX package on the same numpy inputs (CPU).

Tolerances: single sweeps and steps 1e-6 max-abs (the red-black sweep is
bit-equal; JAX compiles the lexicographic wavefront into fused code that
rounds about an ulp apart); the block's plain version against JAX's Pallas
kernel in interpret mode: fields 1e-6, Logger sums rtol 1e-5;
registrations: motion 1e-5 px, equal iteration counts at every level,
errors rtol 1e-4 / atol 1e-6 (the Logger sums are added in another order).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
from jax.experimental.pallas import tpu as pltpu

import opticalflow2d_tpu as J
import opticalflow2d_tpu_torch as T
from _torch_helpers import assert_close, npy, tt
from conftest import make_pair
from opticalflow2d_tpu.pallas_kernels.diffusion_block import stack_derivs as j_stack_derivs
from opticalflow2d_tpu.pallas_kernels.elastic_block import elastic_block_pallas
from opticalflow2d_tpu.solvers import elastic as JE
from opticalflow2d_tpu.solvers.base import derivatives as j_derivatives
from opticalflow2d_tpu_torch.interop import config_from_jax
from opticalflow2d_tpu_torch.kernels.diffusion_block import stack_derivs
from opticalflow2d_tpu_torch.kernels.elastic_block import elastic_block, elastic_block_ref
from opticalflow2d_tpu_torch.solvers import elastic as TE
from opticalflow2d_tpu_torch.solvers.base import derivatives

MU, LAM, OMEGA = 0.25, 0.1, 1.5
MOTION_TOL = 1e-5
SHIFT = (1.5, -0.8)
# Under these parameters the 48x40 pair's Logger stop lands inside a block
# of 4 on every level: iterations [52, 53, 152, 154].
NITER = (200, 200)


def _setup(nx, ny, rng):
    iref, imov = make_pair(nx, ny, shift=(1.2, -0.7))
    u = rng.standard_normal((2, nx, ny)).astype(np.float32)
    u[:, [0, -1], :] = 0
    u[:, :, [0, -1]] = 0
    return iref, imov, u


@pytest.mark.parametrize("shape,ordering,ref_stencil", [
    ((48, 40), "redblack", True),
    ((48, 40), "redblack", False),
    ((64, 48), "redblack", True),
    ((16, 12), "lexicographic", True),
    ((16, 12), "lexicographic", False),
])
def test_sor_sweep_matches_jax(shape, ordering, ref_stencil, rng):
    x = rng.standard_normal((2,) + shape).astype(np.float32)
    b = rng.standard_normal((2,) + shape).astype(np.float32)
    want = JE.sor_sweep(jnp.asarray(x), jnp.asarray(b), MU, LAM, OMEGA, ref_stencil, ordering)
    got = TE.sor_sweep(tt(x), tt(b), MU, LAM, OMEGA, ref_stencil, ordering)
    assert_close(got, want, 1e-6)
    assert np.array_equal(npy(got)[:, 0], x[:, 0])  # borders untouched


@pytest.mark.parametrize("ref_stencil", [True, False])
def test_elastic_step_matches_jax(ref_stencil, rng):
    iref, imov, u = _setup(48, 40, rng)
    jd = j_derivatives(jnp.asarray(iref), jnp.asarray(imov))
    td = derivatives(tt(iref), tt(imov))
    want = JE.elastic_step(jnp.asarray(u), jd, MU, LAM, OMEGA, ref_stencil)
    assert_close(TE.elastic_step(tt(u), td, MU, LAM, OMEGA, ref_stencil), want, 1e-6)


def test_unknown_ordering_raises(rng):
    x = tt(rng.standard_normal((2, 8, 8)))
    with pytest.raises(ValueError, match="ordering"):
        TE.sor_sweep(x, x, MU, LAM, OMEGA, ordering="zigzag")


@pytest.mark.parametrize("k,ref_stencil", [(1, True), (2, True), (4, True), (4, False)])
def test_block_ref_matches_pallas_interpret(k, ref_stencil, rng):
    """The plain version of the elastic block kernel against the TPU kernel,
    run in interpret mode, and the CPU wrapper against the plain version."""
    iref, imov, u = _setup(64, 48, rng)
    jd = j_derivatives(jnp.asarray(iref), jnp.asarray(imov))
    with pltpu.force_tpu_interpret_mode():
        want, want_sums = elastic_block_pallas(
            jnp.asarray(u), j_stack_derivs(jd.grad_i, jd.it), MU, LAM, OMEGA, ref_stencil, k=k)
    d = derivatives(tt(iref), tt(imov))
    g = stack_derivs(d.grad_i, d.it)
    got, sums = elastic_block_ref(tt(u), g, MU, LAM, OMEGA, ref_stencil, k)
    assert_close(got, want, 1e-6)
    assert_close(sums, want_sums, 0.0, 1e-5)
    got_w, sums_w = elastic_block(tt(u), g, MU, LAM, OMEGA, ref_stencil, k)
    assert np.array_equal(npy(got_w), npy(got)) and np.array_equal(npy(sums_w), npy(sums))


def _configs(niter=NITER, **jax_kw):
    jcfg = J.RegConfig(method=J.Method.ELASTIC, niter=niter, nscales=1, nrefine=2, mu=MU,
                       lam=LAM, omega=OMEGA, **jax_kw)
    return jcfg, config_from_jax(jcfg)


def _assert_same_run(got, want):
    assert [t.iterations for t in got.traces] == [int(t.iterations) for t in want.traces]
    assert [t.scale for t in got.traces] == [int(t.scale) for t in want.traces]
    for a, b in zip(got.traces, want.traces):
        assert_close(a.errors, b.errors, 1e-6, 1e-4)
        assert a.regrids == 0
    assert_close(got.motion, want.motion, MOTION_TOL)


@pytest.mark.parametrize("niter,compat", [
    (NITER, J.CompatFlags()),                                  # stops inside blocks
    ((40, 30), J.CompatFlags()),                               # caps inside a block
    (NITER, J.CompatFlags(elastic_stencil_reference=False)),  # symmetric operator
])
def test_register_matches_jax(niter, compat):
    iref, imov = make_pair(48, 40, shift=SHIFT)
    jcfg, tcfg = _configs(niter, compat=compat)
    want = J.register(iref, imov, jcfg)
    got = T.register(tt(iref), tt(imov), tcfg, device="cpu")
    _assert_same_run(got, want)
    assert any(t.iterations % 4 for t in got.traces)  # a stop inside a block of 4
    assert_close(got.coarse_motion, want.coarse_motion, MOTION_TOL)


@pytest.mark.parametrize("block_k", [1, 3, 16])
def test_block_depth_does_not_change_the_result(block_k):
    """Every block depth gives the run of the default depth (k = 4): stops
    inside a block rerun the block for the taken iterations."""
    iref, imov = make_pair(48, 40, shift=SHIFT)
    _, base = _configs()
    want = T.register(iref, imov, base, device="cpu")
    got = T.register(iref, imov, dataclasses.replace(base, block_k=block_k), device="cpu")
    assert [t.iterations for t in got.traces] == [t.iterations for t in want.traces]
    assert np.array_equal(npy(got.motion), npy(want.motion))


def test_register_lexicographic_matches_jax():
    """The reference's sequential sweep, plain PyTorch: one step a pass."""
    iref, imov = make_pair(16, 12, shift=(0.6, -0.4))
    jcfg = J.RegConfig(method=J.Method.ELASTIC, niter=(12,), mu=MU, lam=LAM, omega=OMEGA,
                       sor_ordering="lexicographic")
    want = J.register(iref, imov, jcfg)
    _assert_same_run(T.register(iref, imov, config_from_jax(jcfg), device="cpu"), want)


def test_session_matches_jax():
    iref, imov = make_pair(48, 40, shift=SHIFT)
    args = ((48, 40), list(NITER), 1, J.Method.ELASTIC, [MU, LAM, OMEGA], 2)
    js = J.OpticalFlow2d(*args)
    ts = T.OpticalFlow2d(*args, device="cpu")
    _assert_same_run(ts.register(iref, imov), js.register(iref, imov))
    assert tuple(ts.get_motion().shape) == (48, 40, 2)
    assert_close(ts.get_motion(), js.get_motion(), MOTION_TOL)
    assert_close(ts.warp(imov), js.warp(imov), 1e-5)


@pytest.mark.parametrize("method", [J.Method.ELASTIC, J.Method.FLUID])
def test_config_from_jax_elastic_and_fluid(method):
    jcfg = J.RegConfig.from_regparams(
        method, [30, 20], 1, [0.3, 0.2, 1.2], 2, use_pallas=True, pallas_block_k=6,
        pallas_block_elastic=True, pallas_block_k_elastic=2, dumax=0.4,
        regrid_threshold=0.7, timestep_skip=30.0, sor_ordering="lexicographic",
        compat=J.CompatFlags(maxabs_bug=True, elastic_stencil_reference=False))
    tcfg = config_from_jax(jcfg)
    assert tcfg == T.RegConfig.from_regparams(
        T.Method(int(method)), [30, 20], 1, [0.3, 0.2, 1.2], 2, block_k=6, dumax=0.4,
        regrid_threshold=0.7, timestep_skip=30.0, sor_ordering="lexicographic",
        compat=T.CompatFlags(maxabs_bug=True, elastic_stencil_reference=False))
    for field in ("mu", "lam", "omega", "dumax", "regrid_threshold", "timestep_skip"):
        assert getattr(tcfg, field) == getattr(jcfg, field)
