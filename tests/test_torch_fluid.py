"""The port's viscous-fluid step, its kernels' plain versions and the fluid
registration against the JAX package on the same numpy inputs (CPU).

The registrations are held against ``opticalflow2d_tpu.register`` run op by
op (``jax.disable_jit()``), where each jnp operation rounds once, as in the
port. Compiled by XLA, the same program contracts multiply-adds into fused
multiply-adds, an ulp apart, and the fluid timestep ``dt = dumax / max|R|``
amplifies them over a level with tens of regrids (1.8e-3 px at 48x40 on
the default regrid threshold), though every iteration and regrid count
still matches; one compiled run whose drift stays small is held too. JAX
runs its exact gather (``warp_halo=0``).

Tolerances: steps and the plain versions of the kernels 1e-6 max-abs
against JAX's jnp functions and interpret-mode Pallas kernels; Logger sums
rtol 1e-5, the minimum Jacobian determinant rtol 2e-6 (the JAX package's
own pin, ``logger_norms.py:140-142``); registrations: motion 1e-5 px,
equal iteration and regrid counts at every (level, refinement), errors
rtol 1e-4 / atol 1e-6 (the Logger sums are added in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.experimental.pallas import tpu as pltpu

import opticalflow2d_tpu as J
import opticalflow2d_tpu_torch as T
from _torch_helpers import assert_close, npy, tt
from conftest import make_pair
from opticalflow2d_tpu.ops.grid import jacobian_det as j_jacobian_det
from opticalflow2d_tpu.pallas_kernels.diffusion_block import stack_derivs as j_stack_derivs
from opticalflow2d_tpu.pallas_kernels.fluid_fused import fluid_iter_pallas
from opticalflow2d_tpu.pallas_kernels.logger_norms import fluid_metrics_pallas
from opticalflow2d_tpu.solvers.base import derivatives as j_derivatives
from opticalflow2d_tpu.solvers.fluid import make_fluid_step as j_make_fluid_step
from opticalflow2d_tpu_torch.interop import config_from_jax
from opticalflow2d_tpu_torch.kernels.diffusion_block import stack_derivs
from opticalflow2d_tpu_torch.kernels.fluid_fused import fluid_iter, fluid_iter_ref
from opticalflow2d_tpu_torch.kernels.logger_norms import fluid_metrics, fluid_metrics_ref
from opticalflow2d_tpu_torch.ops.reduce import motion_maxabs
from opticalflow2d_tpu_torch.solvers.base import derivatives
from opticalflow2d_tpu_torch.solvers.fluid import make_fluid_step

MU, LAM, OMEGA = 0.25, 0.1, 1.5
MOTION_TOL = 1e-5
SHAPE = (48, 40)
NITER = (150, 150)
EXACT = dict(warp_halo=0, warp_halo_outer=0, warp_halo_auto=False)


def _setup(nx, ny, rng):
    iref, imov = make_pair(nx, ny, shift=(1.2, -0.7))
    u = (0.6 * np.tanh(rng.standard_normal((2, nx, ny)))).astype(np.float32)
    vel = (0.3 * np.tanh(rng.standard_normal((2, nx, ny)))).astype(np.float32)
    vel[:, [0, -1], :] = 0
    vel[:, :, [0, -1]] = 0
    return iref, imov, u, vel


def _g(iref, imov):
    d = derivatives(tt(iref), tt(imov))
    return stack_derivs(d.grad_i, d.it)


@pytest.mark.parametrize("ref_stencil,bug,ordering", [
    (True, False, "redblack"), (False, False, "redblack"), (True, True, "redblack"),
    (True, False, "lexicographic"),
])
def test_fluid_step_matches_jax(ref_stencil, bug, ordering, rng):
    """Four chained steps through the velocity, against JAX's jnp step."""
    shape = (16, 12) if ordering == "lexicographic" else SHAPE
    iref, imov, u, vel = _setup(*shape, rng)
    jd = j_derivatives(jnp.asarray(iref), jnp.asarray(imov))
    j_step = j_make_fluid_step(MU, LAM, OMEGA, maxabs_bug=bug, reference_stencil=ref_stencil,
                               sor_ordering=ordering)
    t_step = make_fluid_step(MU, LAM, OMEGA, maxabs_bug=bug, reference_stencil=ref_stencil,
                             sor_ordering=ordering)
    ju, jv, tu, tv, g = jnp.asarray(u), jnp.asarray(vel), tt(u), tt(vel), _g(iref, imov)
    for _ in range(4):
        ju, jv, _dt = j_step(ju, jv, jd)
        tu, tv = t_step(tu, tv, g)
        assert_close(tu, ju, 1e-6)
        assert_close(tv, jv, 1e-6)


@pytest.mark.parametrize("shape,ref_stencil,bug", [
    ((64, 48), True, False), ((64, 48), True, True), ((96, 40), False, False),
])
def test_fluid_iter_ref_matches_pallas_interpret(shape, ref_stencil, bug, rng):
    iref, imov, u, vel = _setup(*shape, rng)
    jd = j_derivatives(jnp.asarray(iref), jnp.asarray(imov))
    with pltpu.force_tpu_interpret_mode():
        want_v, want_r, want_m = fluid_iter_pallas(
            jnp.asarray(u), jnp.asarray(vel), j_stack_derivs(jd.grad_i, jd.it), MU, LAM, OMEGA,
            ref_stencil, bug)
    g = _g(iref, imov)
    got_v, got_r, got_m = fluid_iter_ref(tt(u), tt(vel), g, MU, LAM, OMEGA, ref_stencil, bug)
    assert_close(got_v, want_v, 1e-6)
    assert_close(got_r, want_r, 1e-6)
    assert_close(got_m, want_m, 0.0, 1e-6)
    # max is exact in any order: sqrt(maxsq) is maxabs of the step's own R.
    assert np.float32(np.sqrt(np.float64(npy(got_m)))) == npy(motion_maxabs(got_r, bug))
    wrapped = fluid_iter(tt(u), tt(vel), g, MU, LAM, OMEGA, ref_stencil, bug)
    assert all(np.array_equal(npy(a), npy(b)) for a, b in zip(wrapped, (got_v, got_r, got_m)))


@pytest.mark.parametrize("shape,scale", [((64, 48), 0.5), ((48, 40), 3.0)])
def test_fluid_metrics_ref_matches_pallas_interpret(shape, scale, rng):
    """A field of up to ``scale`` px: at 3 px the determinant goes below the
    regrid threshold somewhere."""
    u_new = (scale * np.tanh(rng.standard_normal((2,) + shape))).astype(np.float32)
    u_prev = (0.8 * u_new + 0.1 * rng.standard_normal((2,) + shape)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want_sums, want_jac = fluid_metrics_pallas(jnp.asarray(u_new), jnp.asarray(u_prev))
    got = fluid_metrics_ref(tt(u_new), tt(u_prev))
    assert_close(got[:2], want_sums, 0.0, 1e-5)
    assert_close(got[2], want_jac, 0.0, 2e-6)
    assert_close(got[2], jnp.min(j_jacobian_det(jnp.asarray(u_new))), 0.0, 2e-6)
    assert np.array_equal(npy(fluid_metrics(tt(u_new), tt(u_prev))), npy(got))
    if scale > 1:
        assert float(got[2]) < 0.5


# name -> JAX config fields; mu = 0.25, lambda = 0.
CASES = {
    "regrids": dict(regrid_threshold=0.95),
    "skips_every_step": dict(timestep_skip=1.0),
    "maxabs_bug": dict(compat=J.CompatFlags(maxabs_bug=True)),
    "symmetric_stencil": dict(compat=J.CompatFlags(elastic_stencil_reference=False)),
}


def _configs(name, **extra):
    jcfg = J.RegConfig(method=J.Method.FLUID, niter=NITER, nscales=1, nrefine=2, mu=0.25,
                       lam=0.0, **EXACT, **CASES[name], **extra)
    return jcfg, config_from_jax(jcfg)


def _assert_same_run(got, want):
    assert [t.iterations for t in got.traces] == [int(t.iterations) for t in want.traces]
    assert [t.regrids for t in got.traces] == [int(t.regrids) for t in want.traces]
    assert [t.scale for t in got.traces] == [int(t.scale) for t in want.traces]
    for a, b in zip(got.traces, want.traces):
        assert_close(a.errors, b.errors, 1e-6, 1e-4)
    assert_close(got.motion, want.motion, MOTION_TOL)


@pytest.mark.parametrize("name", list(CASES))
def test_register_matches_jax(name):
    iref, imov = make_pair(*SHAPE, shift=(1.5, -0.8))
    jcfg, tcfg = _configs(name)
    with jax.disable_jit():
        want = J.register(iref, imov, jcfg)
    got = T.register(tt(iref), tt(imov), tcfg, device="cpu")
    _assert_same_run(got, want)
    assert_close(got.coarse_motion, want.coarse_motion, MOTION_TOL)
    regrids = [t.regrids for t in got.traces]
    if name == "skips_every_step":
        assert [t.iterations for t in got.traces] == [3] * 4
        assert not npy(got.motion).any() and not any(regrids)
    else:
        assert any(regrids) and npy(got.motion).any()


def test_register_matches_compiled_jax():
    """JAX's register as it runs by default, compiled, on a config whose
    fused multiply-adds stay below the gate: 10 regrids on the coarse level."""
    iref, imov = make_pair(*SHAPE, shift=(1.5, -0.8))
    jcfg, tcfg = _configs("regrids")
    want = J.register(iref, imov, jcfg)
    _assert_same_run(T.register(tt(iref), tt(imov), tcfg, device="cpu"), want)
    assert int(want.traces[0].regrids) == 10


def test_session_matches_jax():
    iref, imov = make_pair(*SHAPE, shift=(1.5, -0.8))
    args = (SHAPE, list(NITER), 1, J.Method.FLUID, [0.25, 0.0], 2)
    js = J.OpticalFlow2d(*args, regrid_threshold=0.95, **EXACT)
    ts = T.OpticalFlow2d(*args, regrid_threshold=0.95, device="cpu")
    with jax.disable_jit():
        want = js.register(iref, imov)
        want_warp = js.warp(imov)
    _assert_same_run(ts.register(iref, imov), want)
    assert tuple(ts.get_motion().shape) == SHAPE + (2,)
    assert_close(ts.get_motion(), js.get_motion(), MOTION_TOL)
    assert_close(ts.warp(imov), want_warp, 1e-5)


def test_verbose_fluid_session_prints_regrids(capsys):
    iref, imov = make_pair(24, 20, shift=(1.5, -0.8))
    ts = T.OpticalFlow2d((24, 20), [12], 0, T.Method.FLUID, [0.25, 0.0], verbose=True,
                         regrid_threshold=0.95, device="cpu")
    res = ts.register(iref, imov)
    out = capsys.readouterr().out
    assert "mu:              0.25" in out and "omega (SOR):     0.66" in out
    assert f"scale 0: {res.traces[0].iterations} iterations" in out
    assert f"regrids {res.traces[0].regrids}" in out and res.traces[0].regrids > 0
