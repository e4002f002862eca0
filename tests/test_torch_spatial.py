"""The port's strip-parallel drivers (``opticalflow2d_tpu_torch.parallel``)
against the JAX package's explicit ``shard_map`` drivers, on an 8-strip
mesh at 64x48: the JAX side on the conftest's eight virtual CPU devices,
the port on eight CPU strips, the same numpy inputs (``tiled_pair``, free
of subnormals). And the port's strips against its own dense ``register``.

JAX runs compiled, as its own SP tests do; with ``use_pallas=True`` its
strip kernels run in interpret mode. Compiled XLA contracts multiply-adds
into fused multiply-adds an ulp apart, which the fluid timestep amplifies
over many regrids (1.8e-3 px over 40 regrids at 48x40,
``tests/test_torch_fluid.py``); the fluid runs here are short, with at
most two regrids a level, and stay within 4e-6 px.
Where JAX takes its per-step body and the port its blocked kernel (coarse
strips of 4 rows, below the TPU's 8-row tile), the two round a step apart
by an ulp. The demons runs take parameters under which those ulps stay
small (see ``DEMONS``), one on each route of the strip iteration.

Tolerances: sweeps and the curvature step 1e-6 max-abs; the strip DCT
2e-6 of max |out| (the matmuls add in another order); registrations 1e-5
px with equal iteration counts at every (level, refinement), and equal
regrid counts where JAX reports them.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from jax.experimental.pallas import tpu as pltpu

import opticalflow2d_tpu_torch as T
from _torch_helpers import assert_close, npy, tiled_pair, tt
from opticalflow2d_tpu.parallel import dct_dist as j_dd
from opticalflow2d_tpu.parallel import spatial as j_sp
from opticalflow2d_tpu.parallel.mesh import make_mesh as j_make_mesh
from opticalflow2d_tpu_torch.ops import dct as TD
from opticalflow2d_tpu_torch.ops.warp import expmap_nsq
from opticalflow2d_tpu_torch.parallel import (
    make_curvature_step_sharded, make_dct2_sharded, make_demons_level_sharded,
    make_demons_step_sharded, make_diffusion_sweeps_sharded, make_fluid_level_sharded,
    make_mesh, make_register_demons_sp, make_register_sp, make_sor_sweeps_sharded,
    make_variational_level_sharded, make_warp2d_sharded, spatial)
from opticalflow2d_tpu_torch.solvers import make_curvature_step
from opticalflow2d_tpu_torch.solvers.base import derivatives

SHAPE = (64, 48)
MOTION_TOL = 1e-5


@pytest.fixture(scope="module")
def meshes():
    return j_make_mesh(data=1, x=8), make_mesh(x=8, devices=[torch.device("cpu")] * 8)


@pytest.fixture(scope="module")
def pair():
    return tiled_pair(*SHAPE, shift=(1.2, -0.7))


def _j(*xs):
    return tuple(jnp.asarray(x) for x in xs)


def test_diffusion_sweeps_sharded_matches_jax(meshes, pair):
    jmesh, mesh = meshes
    d = derivatives(*map(tt, pair[::-1]))
    u = np.random.default_rng(1).standard_normal((2,) + SHAPE).astype(np.float32)
    args = (u, npy(d.grad_i), npy(d.it))
    want = j_sp.make_diffusion_sweeps_sharded(jmesh, alpha=0.5, niter=15)(*_j(*args))
    got = make_diffusion_sweeps_sharded(mesh, alpha=0.5, niter=15)(*map(tt, args))
    assert_close(got, want, 1e-6)


def test_sor_sweeps_sharded_matches_jax(meshes):
    jmesh, mesh = meshes
    rng = np.random.default_rng(2)
    x, b = (rng.standard_normal((2,) + SHAPE).astype(np.float32) for _ in range(2))
    want = j_sp.make_sor_sweeps_sharded(jmesh, 0.5, 0.1, 0.66, niter=5)(*_j(x, b))
    got = make_sor_sweeps_sharded(mesh, 0.5, 0.1, 0.66, niter=5)(tt(x), tt(b))
    assert_close(got, want, 1e-6)


@pytest.mark.parametrize("method,kw", [("diffusion", dict(alpha=0.5)),
                                       ("elastic", dict(mu=0.5, lam=0.0)),
                                       ("curvature", dict(alpha=0.1, tau=1.0))])
def test_variational_level_sharded_matches_jax(meshes, pair, method, kw):
    jmesh, mesh = meshes
    u0 = np.zeros((2,) + SHAPE, np.float32)
    want_u, want_it = j_sp.make_variational_level_sharded(jmesh, method, niter=20, halo=4,
                                                          **kw)(*_j(u0, *pair))
    got_u, got_it = make_variational_level_sharded(mesh, method, niter=20, halo=4, **kw)(
        *map(tt, (u0, *pair)))
    assert got_it == int(want_it)
    assert_close(got_u, want_u, MOTION_TOL)


def test_fluid_level_sharded_matches_jax(meshes, pair):
    jmesh, mesh = meshes
    u0 = np.zeros((2,) + SHAPE, np.float32)
    want = j_sp.make_fluid_level_sharded(jmesh, 0.25, 0.0, 0.66, niter=15, halo=5)(
        *_j(u0, *pair))
    got = make_fluid_level_sharded(mesh, 0.25, 0.0, 0.66, niter=15, halo=5)(
        *map(tt, (u0, *pair)))
    assert (got[1], got[2]) == (int(want[1]), int(want[2]))
    assert got[2] > 0
    assert_close(got[0], want[0], MOTION_TOL)


# The demons strip routes (parallel.spatial.demons_strip_route) at halo 2:
# Thirion's correspondence bound sigma_x / (2 sigma_i) is 0.5 (K5), 2.5
# (past the halo: K6, K7); diffeomorphic demons at bound 1 squares once (K6,
# the exp map, K7); kernelwidth 45 does not fit the kernels' tile (the op
# chain). sigma_diffusion 2 keeps the registrations' motion under 3 px,
# inside the contract at halo 4: with 1, the motion reaches 4-5 px, and at
# a bound of 2 or more the force's small denominator amplifies the ulps of
# compiled XLA's fused multiply-adds to 1e-4 px in ten iterations.
DEMONS = {
    "thirion_onepass": ("thirions", dict(sigma_i=1.0, sigma_x=1.0, sigma_diffusion=2.0,
                                         sigma_fluid=2.0, kernelwidth=5)),
    "thirion_two_kernel": ("thirions", dict(sigma_i=0.2, sigma_x=1.0, sigma_diffusion=2.0,
                                            sigma_fluid=1.5, kernelwidth=5)),
    "diffeo_two_kernel": ("diffeo", dict(sigma_i=0.5, sigma_x=1.0, sigma_diffusion=2.0,
                                         sigma_fluid=2.0, kernelwidth=7)),
    "diffeo_op_chain": ("diffeo", dict(sigma_i=0.5, sigma_x=1.0, sigma_diffusion=2.0,
                                       sigma_fluid=2.0, kernelwidth=45)),
}
ROUTES = {"thirion_onepass": "onepass", "thirion_two_kernel": "two_kernel",
          "diffeo_two_kernel": "two_kernel", "diffeo_op_chain": "op_chain"}


def _squarings(monkeypatch):
    """Record the squaring counts of the strip exp map."""
    seen = []

    def nsq(m):
        seen.append(expmap_nsq(m))
        return seen[-1]

    monkeypatch.setattr(spatial, "expmap_nsq", nsq)
    return seen


@pytest.mark.parametrize("name", list(DEMONS))
def test_demons_step_sharded_matches_jax(meshes, pair, name):
    jmesh, mesh = meshes
    family, p = DEMONS[name]
    assert spatial.demons_strip_route(family, p, 2) == ROUTES[name]
    u = (0.8 * np.tanh(np.random.default_rng(3).standard_normal((2,) + SHAPE))).astype(
        np.float32)
    kw = dict(halo=2, diffeomorphic=family == "diffeo")
    want = j_sp.make_demons_step_sharded(jmesh, **p, **kw)(*_j(u, *pair))
    got = make_demons_step_sharded(mesh, **p, **kw)(*map(tt, (u, *pair)))
    assert_close(got, want, MOTION_TOL)


@pytest.mark.parametrize("name", ["thirion_onepass", "diffeo_two_kernel"])
def test_demons_level_sharded_matches_jax(meshes, pair, name, monkeypatch):
    jmesh, mesh = meshes
    family, p = DEMONS[name]
    seen = _squarings(monkeypatch)
    u0 = np.zeros((2,) + SHAPE, np.float32)
    kw = dict(niter=20, halo=2, diffeomorphic=family == "diffeo")
    want_u, want_it = j_sp.make_demons_level_sharded(jmesh, **p, **kw)(*_j(u0, *pair))
    got_u, got_it = make_demons_level_sharded(mesh, **p, **kw)(*map(tt, (u0, *pair)))
    assert got_it == int(want_it)
    assert_close(got_u, want_u, MOTION_TOL)
    assert any(seen) == (family == "diffeo")


# name -> (family, make_register_sp keywords, JAX runs its strip kernels)
SP_CASES = {
    "diffusion_block4": ("diffusion", dict(niter=[8, 6], halo=4, alpha=0.5, block_k=4), True),
    "diffusion_block8": ("diffusion", dict(niter=[30, 20], halo=4, alpha=0.5, block_k=8),
                         True),
    "elastic_block4": ("elastic", dict(niter=[8, 6], halo=4, mu=0.5, lam=0.0, block_k=4),
                       True),
    "elastic": ("elastic", dict(niter=[8, 6], halo=4, mu=0.5, lam=0.0), False),
    "fluid": ("fluid", dict(niter=[10, 8], halo=5, mu=0.25, lam=0.0), False),
    "diffusion_nrefine2": ("diffusion", dict(niter=[6, 5], nrefine=2, halo=4, alpha=0.5),
                           False),
    "diffusion_nscales2": ("diffusion", dict(niter=[5, 4, 6], nscales=2, halo=4, alpha=0.5),
                           False),
    "thirion_onepass_nrefine2": ("thirions", dict(niter=[10, 8], nrefine=2, halo=4,
                                                  **DEMONS["thirion_onepass"][1]), False),
    "thirion_onepass_pallas": ("thirions", dict(niter=[12, 10], halo=4,
                                                **DEMONS["thirion_onepass"][1]), True),
    "diffeo_two_kernel": ("diffeo", dict(niter=[12, 10], halo=4,
                                         **DEMONS["diffeo_two_kernel"][1]), False),
    "diffeo_op_chain": ("diffeo", dict(niter=[8, 6], halo=4, **DEMONS["diffeo_op_chain"][1]),
                        False),
    "curvature": ("curvature", dict(niter=[20, 15], halo=4, alpha=0.1, tau=1.0), False),
    "curvature_nrefine2": ("curvature", dict(niter=[12, 10], nrefine=2, halo=4, alpha=0.1),
                           False),
}


@pytest.mark.parametrize("name", list(SP_CASES))
def test_register_sp_matches_jax(meshes, pair, name):
    jmesh, mesh = meshes
    family, kw, pallas = SP_CASES[name]
    kw = {"nscales": 1, **kw}
    solve = j_sp.make_register_sp(jmesh, family, use_pallas=pallas, **kw)
    if pallas:
        with pltpu.force_tpu_interpret_mode():
            want_u, want_it = solve(*_j(*pair))
    else:
        want_u, want_it = solve(*_j(*pair))
    got = make_register_sp(mesh, family, **kw)(*map(tt, pair))
    assert list(got.iterations) == [int(v) for v in np.asarray(want_it)]
    assert_close(got.motion, want_u, MOTION_TOL)
    assert npy(got.motion).any()
    if family == "fluid":
        assert any(got.regrids)


@pytest.mark.parametrize("family,kw,cfg_kw", [
    ("diffusion", dict(alpha=0.5, block_k=8), dict(method=T.Method.DIFFUSION, alpha=0.5)),
    ("elastic", dict(mu=0.5, lam=0.0, block_k=4), dict(method=T.Method.ELASTIC, mu=0.5,
                                                       lam=0.0)),
    ("fluid", dict(mu=0.25, lam=0.0), dict(method=T.Method.FLUID, mu=0.25, lam=0.0)),
    ("thirions", DEMONS["thirion_onepass"][1],
     dict(method=T.Method.THIRIONS_DEMONS, **DEMONS["thirion_onepass"][1])),
    ("diffeo", DEMONS["diffeo_two_kernel"][1],
     dict(method=T.Method.DIFFEOMORPHIC_DEMONS, **DEMONS["diffeo_two_kernel"][1])),
    # The strips keep the dense per-axis transform: dct_impl="matmul".
    ("curvature", dict(alpha=0.1, tau=1.0),
     dict(method=T.Method.CURVATURE, alpha=0.1, tau=1.0, dct_impl="matmul")),
])
def test_register_sp_matches_dense_register(meshes, pair, family, kw, cfg_kw):
    """Strips against the port's own dense driver, as the JAX package's SP
    tests hold its strips against its ``register``: at ``nrefine=1`` the
    strip semantics (velocity restart, strip pyramid, contract) give the
    same run."""
    _, mesh = meshes
    got = make_register_sp(mesh, family, niter=[10, 8], nscales=1, halo=5, **kw)(
        *map(tt, pair))
    want = T.register(*map(tt, pair), T.RegConfig(niter=(10, 8), nscales=1, **cfg_kw),
                      device="cpu")
    assert list(got.iterations) == [t.iterations for t in want.traces]
    assert list(got.regrids) == [t.regrids for t in want.traces]
    assert_close(got.motion, want.motion, MOTION_TOL)


@pytest.mark.parametrize("inverse", [False, True])
def test_dct2_sharded_matches_jax(meshes, inverse):
    jmesh, mesh = meshes
    a = np.random.default_rng(6).standard_normal(SHAPE).astype(np.float32)
    want = j_dd.make_dct2_sharded(jmesh, *SHAPE, inverse=inverse)(jnp.asarray(a))
    got = make_dct2_sharded(mesh, *SHAPE, inverse=inverse)(tt(a))
    assert_close(got, want, 2e-6 * float(np.abs(np.asarray(want)).max()))
    dense = (TD.idct2_fftw if inverse else TD.dct2_fftw)(tt(a))
    assert_close(got, dense, 2e-6 * float(dense.abs().max()))


def test_curvature_step_sharded_matches_jax(meshes, pair):
    """JAX's step at HIGHEST, the dense per-axis transform at full float32."""
    jmesh, mesh = meshes
    d = derivatives(*map(tt, pair[::-1]))
    u = (1.5 * np.tanh(np.random.default_rng(7).standard_normal((2,) + SHAPE))).astype(
        np.float32)
    args = (u, npy(d.grad_i), npy(d.it))
    want = j_dd.make_curvature_step_sharded(jmesh, *SHAPE, 0.1, 1.0,
                                            precision=lax.Precision.HIGHEST)(*_j(*args))
    got = make_curvature_step_sharded(mesh, *SHAPE, 0.1, 1.0)(*map(tt, args))
    assert_close(got, want, 1e-6)
    dense = make_curvature_step(*SHAPE, 0.1, 1.0, dct_impl="matmul")(tt(u), d)
    assert_close(got, dense, 1e-6)


def test_curvature_strips_need_ny_divisible_by_the_strips(meshes):
    _, mesh = meshes
    with pytest.raises(ValueError, match="ny \\(44\\) divisible"):
        make_register_sp(mesh, "curvature", niter=[3], nscales=0, alpha=0.1)(
            *map(tt, tiled_pair(64, 44)))
    with pytest.raises(ValueError, match="divide the mesh"):
        make_variational_level_sharded(mesh, "curvature", niter=3, grid_shape=(64, 44))
    for factory in (make_dct2_sharded, make_curvature_step_sharded):
        with pytest.raises(ValueError, match="divisible"):
            factory(mesh, 64, 44, *((0.1, 1.0) if factory is make_curvature_step_sharded
                                    else ()))


def test_register_demons_sp_matches_jax(meshes, pair):
    """The Thirion wrapper (the K5 route at nrefine 1), at the JAX package's
    default kernelwidth."""
    jmesh, mesh = meshes
    p = dict(sigma_i=1.0, sigma_x=0.5, sigma_diffusion=1.0, sigma_fluid=1.0, kernelwidth=5,
             niter=[10, 8], nscales=1, halo=2)
    want_u, want_it = j_sp.make_register_demons_sp(jmesh, **p)(*_j(*pair))
    got = make_register_demons_sp(mesh, **p)(*map(tt, pair))
    assert list(got.iterations) == [int(v) for v in np.asarray(want_it)]
    assert_close(got.motion, want_u, MOTION_TOL)


def test_strip_drivers_refuse_what_is_not_ported(meshes, pair):
    """A data axis still raises; the demons families run."""
    _, mesh = meshes
    for family in ("thirions", "diffeo"):
        got = make_register_sp(mesh, family, niter=[2], nscales=0, **DEMONS["thirion_onepass"][1])(
            *map(tt, pair))
        assert got.iterations == (2,)
    with pytest.raises(ValueError, match="devices="):
        make_mesh(x=4, devices=["cpu"] * 2)
    with pytest.raises(NotImplementedError, match="item 15"):
        make_warp2d_sharded(make_mesh(data=2, x=2, devices=["cpu"] * 4), 2)
    with pytest.raises(ValueError, match="divisible"):
        make_register_sp(mesh, "diffusion", niter=[4, 4], nscales=1, alpha=0.5)(
            torch.zeros(72, 48), torch.zeros(72, 48))
