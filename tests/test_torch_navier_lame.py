"""The port's spectral Navier-Lame solvers, boundary conditions and the
elastic and fluid registrations on them, against the JAX package on the
same numpy inputs (CPU).

JAX runs compiled. The solves are exact per iteration, so elastic's field
is a smooth function of the transforms' rounding; the fluid timestep
amplifies rounding as it does on the SOR route (``test_torch_fluid.py``):
the port's own fluid run moves by as much under a one-ulp change of one
input pixel, so the fluid run here is short (12 and 8 iterations a
level, with regrids on every level at threshold 0.95).

Tolerances: the periodic solve 1e-6 of max |v|; the Dirichlet solve, a
float32 CG run to its default 12 or 32 iterations, 5e-6 of max |v|
against JAX and 3e-6 against the exact float64 solution of the interior
system (both packages sit 1-2e-6 from it: a one-ulp change of one input
moves the port's result by 6e-7); the operator 1e-6; the boundaries bit
for bit; registrations 1e-5 px with equal iteration and regrid counts at
every (level, refinement), the Logger errors within 1e-6 (Dirichlet:
1e-5, its solve's noise over the last, small steps).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import opticalflow2d_tpu as J
import opticalflow2d_tpu_torch as T
from _torch_helpers import assert_close, npy, tiled_pair, tt
from opticalflow2d_tpu.ops import boundary as JB
from opticalflow2d_tpu.solvers import navier_lame as JN
from opticalflow2d_tpu.solvers.base import Derivatives as JDerivatives
from opticalflow2d_tpu.solvers.fluid import make_fluid_step as j_make_fluid_step
from opticalflow2d_tpu_torch.interop import config_from_jax
from opticalflow2d_tpu_torch.kernels.diffusion_block import stack_derivs
from opticalflow2d_tpu_torch.ops import dirichlet_boundary, neumann_boundary
from opticalflow2d_tpu_torch.solvers import navier_lame as TN
from opticalflow2d_tpu_torch.solvers.base import derivatives
from opticalflow2d_tpu_torch.solvers.fluid import make_fluid_step

SHAPE = (64, 48)
MOTION_TOL = 1e-5
# (mu, lam): lam below, equal to and above mu (within the 4 mu bound of the
# reference stencil).
PARAMS = [(0.5, 0.0), (0.25, 0.25), (0.25, 0.75)]


def _force(shape=SHAPE, seed=0):
    return np.random.default_rng(seed).standard_normal((2,) + shape).astype(np.float32)


def _rel(got, want) -> float:
    want = np.asarray(want)
    return float(np.abs(npy(got) - want).max() / np.abs(want).max())


@pytest.mark.parametrize("mu,lam", PARAMS + [(0.25, 2.0)])
def test_periodic_solve_matches_jax(mu, lam):
    f = _force()
    want = JN.make_spectral_navier_lame_solver(*SHAPE, mu, lam)(jnp.asarray(f))
    got = TN.make_spectral_navier_lame_solver(*SHAPE, mu, lam)(tt(f))
    assert got.dtype == torch.float32 and tuple(got.shape) == (2,) + SHAPE
    assert _rel(got, want) <= 1e-6


def test_periodic_solve_inverts_the_periodic_operator():
    """The solve of ``f`` with zero mean, put back through the periodic
    stencil, gives ``f``."""
    mu, lam = 0.3, 0.2
    f = _force((32, 28), 1)
    f -= f.mean(axis=(1, 2), keepdims=True)
    v = TN.make_spectral_navier_lame_solver(32, 28, mu, lam, dtype=torch.float64)(tt(f)).double()

    def shift(a, dx, dy):
        return torch.roll(a, (dx, dy), (-2, -1))

    d2x = shift(v, 1, 0) + shift(v, -1, 0) - 2 * v
    d2y = shift(v, 0, 1) + shift(v, 0, -1) - 2 * v
    dxy = 0.25 * (shift(v, -1, -1) - shift(v, 1, -1) - shift(v, -1, 1) + shift(v, 1, 1))
    av = torch.stack([mu * (d2x[0] + d2y[0]) + (mu + lam) * (d2x[0] + dxy[1]),
                      mu * (d2x[1] + d2y[1]) + (mu + lam) * (d2y[1] + dxy[0])])
    assert_close(av, f.astype(np.float64), 1e-4)


@pytest.mark.parametrize("mu,lam,reference_stencil",
                         [(mu, lam, ref) for mu, lam in PARAMS for ref in (True, False)]
                         + [(0.25, 2.0, False)])  # past 4 mu: the symmetric stencil only
def test_dirichlet_solve_matches_jax(mu, lam, reference_stencil):
    f = _force()
    want = JN.make_dirichlet_navier_lame_solver(*SHAPE, mu, lam,
                                                reference_stencil=reference_stencil)(jnp.asarray(f))
    got = TN.make_dirichlet_navier_lame_solver(*SHAPE, mu, lam,
                                               reference_stencil=reference_stencil)(tt(f))
    assert got.dtype == torch.float32 and tuple(got.shape) == (2,) + SHAPE
    assert not got[:, [0, -1]].any() and not got[:, :, [0, -1]].any()
    assert _rel(got, want) <= 5e-6


@pytest.mark.parametrize("mu,lam,reference_stencil", [(0.5, 0.0, True), (0.25, 0.75, True),
                                                      (0.25, 0.75, False)])
def test_dirichlet_solve_is_near_the_exact_solution(mu, lam, reference_stencil):
    """Against a float64 dense solve of the interior system the port's
    operator defines (itself checked against JAX's below), at 24x20."""
    nx, ny = 24, 20
    f = _force((nx, ny), 2)
    mx, my = nx - 2, ny - 2
    n = 2 * mx * my
    basis = torch.zeros((n, 2, nx, ny), dtype=torch.float64)
    basis[:, :, 1:-1, 1:-1] = torch.eye(n, dtype=torch.float64).reshape(n, 2, mx, my)
    a = torch.stack([TN.apply_navier_lame_operator(b, mu, lam, reference_stencil)[:, 1:-1, 1:-1]
                     .reshape(-1) for b in basis], dim=1)
    exact = np.linalg.solve(a.numpy(), f[:, 1:-1, 1:-1].astype(np.float64).reshape(-1))
    got = TN.make_dirichlet_navier_lame_solver(nx, ny, mu, lam,
                                               reference_stencil=reference_stencil)(tt(f))
    want = JN.make_dirichlet_navier_lame_solver(nx, ny, mu, lam,
                                                reference_stencil=reference_stencil)(jnp.asarray(f))
    exact = exact.reshape(2, mx, my)
    scale = np.abs(exact).max()
    assert np.abs(npy(got)[:, 1:-1, 1:-1] - exact).max() <= 3e-6 * scale
    assert np.abs(np.asarray(want)[:, 1:-1, 1:-1] - exact).max() <= 3e-6 * scale


@pytest.mark.parametrize("reference_stencil", [True, False])
def test_operator_matches_jax(reference_stencil):
    v = _force(seed=3)
    want = JN.apply_navier_lame_operator(jnp.asarray(v), 0.4, 0.3, reference_stencil)
    got = TN.apply_navier_lame_operator(tt(v), 0.4, 0.3, reference_stencil)
    assert_close(got, want, 1e-6)
    assert_close(TN._dxy_interior(tt(v)), JN._dxy_interior(jnp.asarray(v)), 1e-6)


def test_dirichlet_refuses_the_ill_conditioned_corner():
    with pytest.raises(ValueError, match="ill-conditioned"):
        JN.make_dirichlet_navier_lame_solver(*SHAPE, 0.1, 0.5)
    with pytest.raises(ValueError, match="ill-conditioned"):
        TN.make_dirichlet_navier_lame_solver(*SHAPE, 0.1, 0.5)
    # An explicit inner_iters accepts partial convergence, as in JAX; the
    # symmetric stencil is taken at any ratio.
    TN.make_dirichlet_navier_lame_solver(*SHAPE, 0.1, 0.5, inner_iters=4)
    TN.make_dirichlet_navier_lame_solver(*SHAPE, 0.1, 0.5, reference_stencil=False)
    with pytest.raises(ValueError, match="too small"):
        TN.make_dirichlet_navier_lame_solver(2, 8, 0.5, 0.0)


@pytest.mark.parametrize("shape", [(6, 5), (2, 6, 5), (2, 3, 4)])
@pytest.mark.parametrize("name", ["dirichlet_boundary", "neumann_boundary"])
def test_boundaries_bit_equal(shape, name):
    u = np.random.default_rng(4).standard_normal(shape).astype(np.float32)
    fn = {"dirichlet_boundary": dirichlet_boundary, "neumann_boundary": neumann_boundary}[name]
    x = tt(u)
    got = fn(x)
    np.testing.assert_array_equal(npy(got), np.asarray(getattr(JB, name)(jnp.asarray(u))))
    np.testing.assert_array_equal(npy(x), u)  # the input is left as it was


@pytest.mark.parametrize("solver", ["spectral", "spectral_dirichlet"])
def test_fluid_step_matches_jax(solver):
    """One fluid step on a spectral solve: velocity and motion."""
    mu, lam = 0.25, 0.1
    iref, imov = tiled_pair(*SHAPE)
    d = derivatives(tt(iref), tt(imov))
    rng = np.random.default_rng(5)
    u = (0.6 * np.tanh(rng.standard_normal((2,) + SHAPE))).astype(np.float32)
    make = {"spectral": "make_spectral_navier_lame_solver",
            "spectral_dirichlet": "make_dirichlet_navier_lame_solver"}[solver]
    j_step = j_make_fluid_step(mu, lam, 0.66, spectral_solve=getattr(JN, make)(*SHAPE, mu, lam))
    want_u, want_v, _ = j_step(jnp.asarray(u), jnp.zeros((2,) + SHAPE),
                               JDerivatives(jnp.asarray(npy(d.grad_i)), jnp.asarray(npy(d.it))))
    step = make_fluid_step(mu, lam, 0.66, spectral_solve=getattr(TN, make)(*SHAPE, mu, lam))
    got_u, got_v = step(tt(u), torch.zeros((2,) + SHAPE), stack_derivs(d.grad_i, d.it))
    assert_close(got_v, want_v, 5e-6 * float(np.abs(np.asarray(want_v)).max()))
    assert_close(got_u, want_u, 1e-6)


def _assert_same_run(got, want, errors_atol):
    assert [t.iterations for t in got.traces] == [int(t.iterations) for t in want.traces]
    assert [t.regrids for t in got.traces] == [int(t.regrids) for t in want.traces]
    for a, b in zip(got.traces, want.traces):
        assert_close(a.errors, b.errors, errors_atol, 1e-4)
    assert_close(got.motion, want.motion, MOTION_TOL)


# The spectral elastic solves stop at 5 (periodic) and 6 (Dirichlet)
# iterations a level; fluid regrids on every level. The Logger errors
# (step over field) compare within 1e-6, the Dirichlet run's within 1e-5:
# its solve's noise, 2.5e-6 of the field, is 4e-6 of the last errors.
@pytest.mark.parametrize("method,solver,kw,errors_atol", [
    (J.Method.ELASTIC, "spectral", dict(niter=(40, 30), mu=0.5, lam=0.0), 1e-6),
    (J.Method.ELASTIC, "spectral_dirichlet", dict(niter=(40, 30), mu=0.5, lam=0.0), 1e-5),
    (J.Method.FLUID, "spectral", dict(niter=(12, 8), mu=0.25, lam=0.0, regrid_threshold=0.95),
     1e-6),
])
def test_register_matches_jax(method, solver, kw, errors_atol):
    iref, imov = tiled_pair(*SHAPE)
    jcfg = J.RegConfig(method=method, nscales=1, nrefine=2, navier_lame_solver=solver, **kw)
    want = J.register(iref, imov, jcfg)
    got = T.register(tt(iref), tt(imov), config_from_jax(jcfg), device="cpu")
    _assert_same_run(got, want, errors_atol)
    if method == J.Method.FLUID:
        assert all(t.regrids > 0 for t in got.traces)
    else:
        assert all(t.iterations < kw["niter"][0] for t in got.traces)


@pytest.mark.parametrize("method", [T.Method.ELASTIC, T.Method.FLUID])
def test_register_refuses_an_unknown_solver(method):
    iref, imov = tiled_pair(32, 32)
    cfg = T.RegConfig(method=method, niter=(3,), navier_lame_solver="multigrid")
    with pytest.raises(ValueError, match="navier_lame_solver"):
        T.register(iref, imov, cfg, device="cpu")
