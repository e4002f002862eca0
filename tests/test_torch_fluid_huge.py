"""The port's huge-grid fluid route against the JAX package on the CPU: the
plain versions of the two-pass kernels (sweep and max, Euler), the two-pass
step against the one-pass step, ``register_phased`` and the session's route
past an extent of 8192.

The JAX side runs op by op (``jax.disable_jit()``) with its exact gather,
as in ``test_torch_fluid.py``, on the tiled pattern, whose values are never
subnormal (XLA on the CPU flushes subnormals to zero, PyTorch keeps them;
the thin grids of ``conftest.make_pair`` are mostly subnormal tails at the
coarse level).

Tolerances: fields 1e-6 max-abs and ``max |R|`` rtol 1e-6 against JAX's
interpret-mode Pallas kernels and jnp chain; the two-pass step equal to the
one-pass step bit for bit; registrations 1e-5 px with equal iteration and
regrid counts, Logger errors rtol 1e-4 / atol 1e-6 (sums in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import opticalflow2d_tpu as J
import opticalflow2d_tpu_torch as T
from _torch_helpers import assert_close, npy, tiled_pair, tt
from opticalflow2d_tpu.engine.registration import register_phased as j_register_phased
from opticalflow2d_tpu.ops.grid import partial_x as j_partial_x, partial_y as j_partial_y
from opticalflow2d_tpu.ops.reduce import motion_maxabs as j_motion_maxabs
from opticalflow2d_tpu.pallas_kernels.diffusion_block import stack_derivs as j_stack_derivs
from opticalflow2d_tpu.pallas_kernels.fluid_fused import (
    fluid_euler_pallas,
    fluid_sweep_max_pallas,
)
from opticalflow2d_tpu.solvers.base import derivatives as j_derivatives, lssd_force as j_force
from opticalflow2d_tpu.solvers.elastic import sor_sweep as j_sor_sweep
from opticalflow2d_tpu_torch.engine import registration as t_registration
from opticalflow2d_tpu_torch.engine import session as t_session
from opticalflow2d_tpu_torch.interop import config_from_jax
from opticalflow2d_tpu_torch.kernels import fluid_fused
from opticalflow2d_tpu_torch.kernels.diffusion_block import stack_derivs
from opticalflow2d_tpu_torch.kernels.fluid_fused import (
    fluid_euler,
    fluid_euler_ref,
    fluid_sweep_max,
    fluid_sweep_max_ref,
)
from opticalflow2d_tpu_torch.ops.reduce import sqrt_rounded
from opticalflow2d_tpu_torch.solvers.base import derivatives
from opticalflow2d_tpu_torch.solvers.fluid import make_fluid_step, make_fluid_two_pass_step

MU, LAM, OMEGA = 0.25, 0.1, 1.5
MOTION_TOL = 1e-5
EXACT = dict(warp_halo=0, warp_halo_outer=0, warp_halo_auto=False)
THIN = (8224, 32)  # an extent over 8192: the two-pass route


def _setup(nx, ny, rng):
    iref, imov = tiled_pair(nx, ny, shift=(1.2, -0.7))
    u = (0.6 * np.tanh(rng.standard_normal((2, nx, ny)))).astype(np.float32)
    vel = (0.3 * np.tanh(rng.standard_normal((2, nx, ny)))).astype(np.float32)
    vel[:, [0, -1], :] = 0
    vel[:, :, [0, -1]] = 0
    d = derivatives(tt(iref), tt(imov))
    jd = j_derivatives(jnp.asarray(iref), jnp.asarray(imov))
    return u, vel, stack_derivs(d.grad_i, d.it), jd


def _j_material_derivative(u, vel):
    return vel - j_partial_x(u) * vel[0:1] - j_partial_y(u) * vel[1:2]


@pytest.mark.parametrize("ref_stencil,bug", [(True, False), (False, False), (True, True),
                                             (False, True)])
def test_fluid_sweep_max_ref_matches_jax(ref_stencil, bug, rng):
    u, vel, g, jd = _setup(64, 48, rng)
    ju, jv = jnp.asarray(u), jnp.asarray(vel)
    with pltpu.force_tpu_interpret_mode():
        want_v, want_m = fluid_sweep_max_pallas(ju, jv, j_stack_derivs(jd.grad_i, jd.it), MU,
                                                LAM, OMEGA, ref_stencil, bug)
    chain_v = j_sor_sweep(jv, j_force(jd, ju), MU, LAM, OMEGA, ref_stencil, "redblack")
    chain_m = j_motion_maxabs(_j_material_derivative(ju, chain_v), bug=bug)
    got_v, got_sq = fluid_sweep_max_ref(tt(u), tt(vel), g, MU, LAM, OMEGA, ref_stencil, bug)
    got_m = sqrt_rounded(got_sq)
    for v, m in ((want_v, want_m), (chain_v, chain_m)):
        assert_close(got_v, v, 1e-6)
        assert_close(got_m, m, 0.0, 1e-6)
    wrapped = fluid_sweep_max(tt(u), tt(vel), g, MU, LAM, OMEGA, ref_stencil, bug)
    assert all(torch.equal(a, b) for a, b in zip(wrapped, (got_v, got_sq)))


@pytest.mark.parametrize("gate", [0.37, 0.0])
def test_fluid_euler_ref_matches_jax(gate, rng):
    u, vel, _, _ = _setup(64, 48, rng)
    ju, jv = jnp.asarray(u), jnp.asarray(vel)
    with pltpu.force_tpu_interpret_mode():
        want = fluid_euler_pallas(ju, jv, jnp.float32(gate))
    chain = jnp.where(gate > 0, ju + _j_material_derivative(ju, jv) * jnp.float32(gate), ju)
    t_gate = torch.tensor(gate, dtype=torch.float32)
    got = fluid_euler_ref(tt(u), tt(vel), t_gate)
    assert_close(got, want, 1e-6)
    assert_close(got, chain, 1e-6)
    assert torch.equal(fluid_euler(tt(u), tt(vel), t_gate), got)
    if gate == 0.0:
        assert np.array_equal(npy(got), u)


@pytest.mark.parametrize("ref_stencil,bug,skip", [(True, False, 65.0), (False, True, 65.0),
                                                  (True, False, 1e-3)])
def test_two_pass_step_equals_one_pass_step(ref_stencil, bug, skip, rng):
    """Four chained steps; at timestep_skip 1e-3 every step is skipped."""
    u, vel, g, _ = _setup(64, 48, rng)
    kw = dict(timestep_skip=skip, maxabs_bug=bug, reference_stencil=ref_stencil)
    one = make_fluid_step(MU, LAM, OMEGA, **kw)
    two = make_fluid_two_pass_step(MU, LAM, OMEGA, **kw)
    u1, v1, u2, v2 = tt(u), tt(vel), tt(u), tt(vel)
    for _ in range(4):
        u1, v1 = one(u1, v1, g)
        u2, v2 = two(u2, v2, g)
        assert torch.equal(u2, u1) and torch.equal(v2, v1)
    assert torch.equal(u2, tt(u)) == (skip < 1)


def _count_sweeps(monkeypatch):
    calls = []
    ref = fluid_fused.fluid_sweep_max_ref

    def counted(*args, **kw):
        calls.append(args[0].shape)
        return ref(*args, **kw)

    monkeypatch.setattr(fluid_fused, "fluid_sweep_max_ref", counted)
    return calls


def _assert_same_run(got, want):
    assert [t.iterations for t in got.traces] == [int(t.iterations) for t in want.traces]
    assert [t.regrids for t in got.traces] == [int(t.regrids) for t in want.traces]
    for a, b in zip(got.traces, want.traces):
        assert_close(a.errors, b.errors, 1e-6, 1e-4)
    assert_close(got.motion, want.motion, MOTION_TOL)


@pytest.mark.parametrize("nscales", [0, 1])
def test_register_phased_matches_jax(nscales, monkeypatch):
    """A thin grid over 8192: the finest level runs the two-pass route (on
    JAX's host-stepped level loop, on the port's own), the coarser one
    (4112 x 16) the one-pass route. Regrid threshold 0.999: regrids happen."""
    iref, imov = tiled_pair(*THIN)
    jcfg = J.RegConfig(method=J.Method.FLUID, niter=(6, 6), nscales=nscales, nrefine=2,
                       mu=0.25, lam=0.0, regrid_threshold=0.999, **EXACT)
    with jax.disable_jit():
        want = j_register_phased(iref, imov, jcfg)
    calls = _count_sweeps(monkeypatch)
    got = T.register_phased(tt(iref), tt(imov), config_from_jax(jcfg), device="cpu")
    _assert_same_run(got, want)
    assert sum(t.regrids for t in got.traces) > 0
    fine = sum(t.iterations for t in got.traces if t.scale == 0)
    assert calls == [(2,) + THIN] * fine


def test_register_phased_validation_and_warm_start():
    """The errors of the JAX package's register_phased, and its warm
    continuation: equal to register's, different from a cold run."""
    iref, imov = tiled_pair(64, 48, shift=(1.5, -0.9))
    cfg = T.RegConfig(method=T.Method.DIFFUSION, alpha=0.5, niter=(6, 4), nscales=1)
    first = T.register(iref, imov, cfg, device="cpu")
    warm_m = T.register(iref, imov, cfg, initial_coarse_motion=first.coarse_motion,
                        device="cpu")
    warm_p = T.register_phased(iref, imov, cfg, initial_coarse_motion=first.coarse_motion,
                               device="cpu")
    assert torch.equal(warm_p.motion, warm_m.motion)
    cold = T.register_phased(iref, imov, cfg, device="cpu")
    assert not np.allclose(npy(warm_p.motion), npy(cold.motion), atol=1e-4)
    with pytest.raises(ValueError, match="mutually exclusive"):
        T.register_phased(iref, imov, cfg, initial_motion=first.motion,
                          initial_coarse_motion=first.coarse_motion, device="cpu")
    with pytest.raises(ValueError, match="coarsest level"):
        T.register_phased(iref, imov, cfg, initial_coarse_motion=first.motion, device="cpu")
    with pytest.raises(ValueError, match="matching 2D images"):
        T.register_phased(iref, imov[:-1], cfg, device="cpu")
    with pytest.raises(ValueError, match="shrinks the coarsest level"):
        T.register_phased(iref[:6, :6], imov[:6, :6], cfg, device="cpu")


def test_session_huge_grid_goes_through_register_phased(monkeypatch):
    """A persistent_motion fluid session over 8192 calls register_phased
    for the cold and the warm register, and the warm one continues from the
    first's coarsest level, as the JAX session does."""
    iref, imov = tiled_pair(*THIN, shift=(1.0, 0.5))
    args = (THIN, [4, 4], 1, J.Method.FLUID, [0.25, 0.0])
    compat = dict(compat=J.CompatFlags(persistent_motion=True))
    routed = []
    phased = t_registration.register_phased
    monkeypatch.setattr(t_session, "register_phased",
                        lambda *a, **kw: routed.append(1) or phased(*a, **kw))
    ts = T.OpticalFlow2d(*args, compat=T.CompatFlags(persistent_motion=True), device="cpu")
    js = J.OpticalFlow2d(*args, **compat, **EXACT)
    calls = _count_sweeps(monkeypatch)
    motions = []
    for _ in range(2):
        with jax.disable_jit():
            want = js.register(iref, imov)
        _assert_same_run(ts.register(iref, imov), want)
        assert_close(ts.get_motion(), js.get_motion(), MOTION_TOL)
        motions.append(npy(ts.get_motion()))
    assert len(routed) == 2 and len(calls) > 0
    assert not np.allclose(motions[0], motions[1], atol=1e-6)
