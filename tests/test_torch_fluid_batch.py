"""The lockstep fluid driver of ``register_batch`` (``engine.registration.
_solve_level_fluid_batch``) and the pair axes of its kernels' plain
versions (B7 ``fluid_iter_batch``, B5 ``fluid_metrics_batch``, U2
``derive_batch``), on the CPU.

Every pair of a stack registered in lockstep equals its own ``register``,
bit for bit: motion, coarse motion, Logger errors, iteration and regrid
counts. The stack's four pairs are chosen so that the driver's branches
all run, and the tests assert that they do: one pair stops early and never
regrids, two regrid at different iterations, and one runs to the cap and
regrids at its last iteration.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import opticalflow2d_tpu_torch as T
from _torch_helpers import tiled_pair
from opticalflow2d_tpu_torch.engine import registration
from opticalflow2d_tpu_torch.kernels._build import Pairs
from opticalflow2d_tpu_torch.kernels.derive import derive, derive_batch
from opticalflow2d_tpu_torch.kernels.diffusion_block import stack_derivs
from opticalflow2d_tpu_torch.kernels.fluid_fused import (
    fluid_iter, fluid_iter_batch, fluid_iter_batch_ref)
from opticalflow2d_tpu_torch.kernels.logger_norms import (
    fluid_metrics, fluid_metrics_batch, fluid_metrics_batch_ref)
from opticalflow2d_tpu_torch.parallel import register_batch
from opticalflow2d_tpu_torch.parallel.batch import _resolve_impl
from opticalflow2d_tpu_torch.solvers.base import derivatives
from opticalflow2d_tpu_torch.solvers.fluid import make_fluid_batch_step, make_fluid_step
from opticalflow2d_tpu_torch.utils import profiling

SHAPE = (48, 40)
# Pair 0 stops at iteration 3 of every solve and never regrids; pairs 1 and
# 2 regrid at their coarse level, at different iterations; pair 3 runs to
# the cap of 12 at both levels and regrids at the last iteration of its
# finest solve.
SHIFTS = ((0.1, 0.05), (1.5, -0.8), (2.2, -1.4), (4.5, -3.0))
CFG = T.RegConfig(method=T.Method.FLUID, niter=(12, 12), nscales=1, nrefine=2, mu=0.25,
                  lam=0.0)


@pytest.fixture(scope="module")
def stacks():
    pairs = [tiled_pair(*SHAPE, shift=s, seed=i) for i, s in enumerate(SHIFTS)]
    return np.stack([p[0] for p in pairs]), np.stack([p[1] for p in pairs])


@pytest.fixture(scope="module")
def singles(stacks):
    return [T.register(stacks[0][i], stacks[1][i], CFG, device="cpu")
            for i in range(len(SHIFTS))]


def _recorded(monkeypatch):
    """The pairs of each batched regrid, with those still iterating."""
    calls = []
    original = registration._regrid_batch

    def regrid(u, g, new, held, again, still, *args):
        calls.append((tuple(u.shape[-2:]), list(again), list(still)))
        return original(u, g, new, held, again, still, *args)

    monkeypatch.setattr(registration, "_regrid_batch", regrid)
    return calls


def _assert_each_register(got, singles) -> None:
    """Every pair of the lockstep result as its own ``register``, bit for
    bit: motion, coarse motion, iteration and regrid counts, errors."""
    for i, one in enumerate(singles):
        assert torch.equal(got.motion[i], one.motion)
        assert torch.equal(got.coarse_motion[i], one.coarse_motion)
        assert [int(t.iterations[i]) for t in got.traces] == [t.iterations for t in one.traces]
        assert [int(t.regrids[i]) for t in got.traces] == [t.regrids for t in one.traces]
        for a, b in zip(got.traces, one.traces):
            assert torch.equal(a.errors[i], b.errors)


@pytest.mark.parametrize("impl", ["vmap", "auto"])
def test_lockstep_fluid_equals_each_register(stacks, singles, impl, monkeypatch):
    calls = _recorded(monkeypatch)
    got = register_batch(*stacks, CFG, impl=impl, device="cpu")
    _assert_each_register(got, singles)
    # The stack takes every branch of the driver.
    its = [[t.iterations for t in one.traces] for one in singles]
    regrids = [[t.regrids for t in one.traces] for one in singles]
    assert its[0] == [3, 3, 3, 3] and regrids[0] == [0, 0, 0, 0]
    assert regrids[1][0] > 0 and regrids[2][0] > 0
    assert any(1 in again and 2 not in again for _, again, _ in calls)
    assert any(2 in again and 1 not in again for _, again, _ in calls)
    assert its[3][-1] == CFG.niter[0] and regrids[3][-1] > 0
    assert calls[-1][1:] == ([3], [])  # a regrid at the cap, nothing left to iterate
    assert all(len(again) >= 1 for _, again, _ in calls)


@pytest.mark.parametrize("chunk", [2, 4])
def test_lockstep_fluid_in_other_chunks_equals_each_register(stacks, singles, chunk,
                                                             monkeypatch):
    """The regrids, the row copies and the Euler tail's gathers in chunks
    of other sizes than a quarter of the stack (``_fluid_chunk``: one pair
    here, a few hundred at 640 pairs): every pair as its own ``register``
    still, bit for bit. Two splits the tail of three pairs; four takes
    every list in one chunk. Some regrids hold several pairs."""
    monkeypatch.setattr(registration, "_fluid_chunk", lambda b: chunk)
    calls = _recorded(monkeypatch)
    got = register_batch(*stacks, CFG, impl="vmap", device="cpu")
    _assert_each_register(got, singles)
    assert any(len(again) > 1 for _, again, _ in calls)


def test_lockstep_fluid_reads_once_an_iteration(stacks, singles, monkeypatch):
    """One B5 and one host read an iteration for all the pairs still
    iterating: as many as the slowest pair's iterations in each solve,
    where the map path reads once an iteration for each pair."""
    launched = []
    original = registration.fluid_metrics_batch

    def metrics(u_new, u_prev, pairs):
        launched.append(len(pairs))
        return original(u_new, u_prev, pairs)

    monkeypatch.setattr(registration, "fluid_metrics_batch", metrics)
    got = register_batch(*stacks, CFG, impl="vmap", device="cpu")
    assert len(launched) == sum(int(t.iterations.max()) for t in got.traces)
    assert sum(launched) == sum(int(t.iterations.sum()) for t in got.traces)
    assert max(launched) == len(SHIFTS) and min(launched) == 1


def test_lockstep_fluid_spans(stacks):
    """A ``read`` span of site ``fluid_batch`` an iteration inside the
    solves, and a ``regrid`` span for each batched regrid, carrying the
    number of pairs it regrids, with its ``compose`` and ``derive``."""
    profiling.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        got = register_batch(*stacks, CFG, impl="vmap", device="cpu")
    records = profiling.records()
    profiling.clear()
    names = [r[0] for r in records]
    reads = [r for r in records if r[0] == "read"]
    assert len(reads) == sum(int(t.iterations.max()) for t in got.traces)
    assert all(r[5] == {"site": "fluid_batch"} and names[r[3]] == "solve" for r in reads)
    regrids = [(i, r) for i, r in enumerate(records) if r[0] == "regrid"]
    assert regrids and all(names[r[3]] == "solve" for _, r in regrids)
    assert sum(r[5]["pairs"] for _, r in regrids) == sum(int(t.regrids.sum())
                                                        for t in got.traces)
    for i, _ in regrids:
        assert sorted(r[0] for r in records if r[3] == i) == ["compose", "derive"]


def test_warm_start_leaves_the_initial_motions_alone(stacks):
    """``initial_motions`` seeds each pair as ``register(initial_motion=...)``
    does, and the driver writes into no tensor of the caller's: with one
    level, the solve starts from the caller's fields, and the first
    refinement's regrids compose into a copy of them."""
    cfg = T.RegConfig(method=T.Method.FLUID, niter=(12,), nrefine=2, mu=0.25, lam=0.0)
    warm = torch.zeros((len(SHIFTS), 2) + SHAPE)
    warm[:, 0], warm[:, 1] = -1.0, 1.0
    kept = warm.clone()
    got = register_batch(*stacks, cfg, impl="vmap", initial_motions=warm, device="cpu")
    assert torch.equal(warm, kept)
    assert int(got.traces[0].regrids.sum()) > 0
    for i in range(len(SHIFTS)):
        one = T.register(stacks[0][i], stacks[1][i], cfg, initial_motion=warm[i], device="cpu")
        assert torch.equal(got.motion[i], one.motion)
        assert [int(t.iterations[i]) for t in got.traces] == [t.iterations for t in one.traces]
        assert [int(t.regrids[i]) for t in got.traces] == [t.regrids for t in one.traces]


def test_a_level_past_8192_keeps_map():
    """Past an extent of 8192 a fluid level takes the two-pass step, which
    has no pair axis: ``auto`` maps, ``vmap`` refuses."""
    cfg = T.RegConfig(method=T.Method.FLUID, niter=(2,), mu=0.25, lam=0.0)
    assert _resolve_impl(cfg, "auto", (8200, 16)) == "map"
    assert _resolve_impl(cfg, "auto", (8192, 16)) == "vmap"
    rng = np.random.default_rng(0)
    irefs = rng.uniform(0.2, 1.0, (2, 8200, 16)).astype(np.float32)
    imovs = np.roll(irefs, 1, axis=1)
    with pytest.raises(NotImplementedError, match="two-pass"):
        register_batch(irefs, imovs, cfg, impl="vmap", device="cpu")
    with pytest.raises(NotImplementedError, match="two-pass"):
        registration._register_batch_impl(torch.from_numpy(irefs), torch.from_numpy(imovs),
                                          cfg)
    got = register_batch(irefs, imovs, cfg, device="cpu")
    for i in range(2):
        assert torch.equal(got.motion[i], T.register(irefs[i], imovs[i], cfg,
                                                     device="cpu").motion)


@pytest.mark.parametrize("overrides", [dict(sor_ordering="lexicographic"),
                                       dict(navier_lame_solver="spectral")])
def test_fluid_without_a_pair_axis_maps(stacks, overrides):
    cfg = T.RegConfig(method=T.Method.FLUID, niter=(3,), mu=0.25, lam=0.0, **overrides)
    assert _resolve_impl(cfg, "auto", SHAPE) == "map"
    with pytest.raises(NotImplementedError, match="red-black SOR"):
        register_batch(*stacks, cfg, impl="vmap", device="cpu")


@pytest.mark.parametrize("method", [T.Method.THIRIONS_DEMONS, T.Method.DIFFEOMORPHIC_DEMONS])
def test_demons_still_refuse_vmap(stacks, method):
    cfg = T.RegConfig(method=method, niter=(5,))
    assert _resolve_impl(cfg, "auto", SHAPE) == "map"
    with pytest.raises(NotImplementedError, match="A15 part 2"):
        register_batch(*stacks, cfg, impl="vmap", device="cpu")


# --- the pair axes' plain versions -------------------------------------------

def _fields(n=4, seed=0):
    rng = np.random.default_rng(seed)
    irefs = torch.from_numpy(rng.uniform(0, 1, (n,) + SHAPE).astype(np.float32))
    imovs = torch.from_numpy(rng.uniform(0, 1, (n,) + SHAPE).astype(np.float32))
    d = derivatives(irefs, imovs)
    g = stack_derivs(d.grad_i, d.it)
    u = torch.from_numpy(rng.normal(0, 0.5, (n, 2) + SHAPE).astype(np.float32))
    vel = torch.from_numpy(rng.normal(0, 0.1, (n, 2) + SHAPE).astype(np.float32))
    return u, vel, g


@pytest.mark.parametrize("pairs", [[0, 1, 2, 3], [3, 1], [2]])
def test_batched_fluid_plain_versions_equal_single_calls(pairs):
    """B7 and B5 batched: each listed pair equals its own single call, R
    and the numbers in list order; pairs not listed are not written."""
    u, vel, g = _fields()
    fill = torch.full_like(vel, 7.0)
    vel_out, r, maxsq = fluid_iter_batch(u, vel, g, 0.25, 0.0, 0.66, pairs=pairs,
                                         vel_out=fill.clone())
    assert r.shape == (len(pairs), 2) + SHAPE and maxsq.shape == (len(pairs),)
    metrics = fluid_metrics_batch(u, vel, pairs)
    assert metrics.shape == (len(pairs), 3)
    for z, p in enumerate(pairs):
        one_vel, one_r, one_maxsq = fluid_iter(u[p], vel[p], g[p], 0.25, 0.0, 0.66)
        assert torch.equal(vel_out[p], one_vel) and torch.equal(r[z], one_r)
        assert torch.equal(maxsq[z], one_maxsq)
        assert torch.equal(metrics[z], fluid_metrics(u[p], vel[p]))
    for p in set(range(4)) - set(pairs):
        assert torch.equal(vel_out[p], fill[p])
    ref_vel, ref_r, ref_maxsq = fluid_iter_batch_ref(u, vel, g, 0.25, 0.0, 0.66,
                                                     pairs=Pairs(pairs, 4))
    assert torch.equal(ref_r, r) and torch.equal(ref_maxsq, maxsq)
    assert torch.equal(fluid_metrics_batch_ref(u, vel, pairs), metrics)


@pytest.mark.parametrize("pairs", [[0, 1, 2, 3], [1, 3]])
def test_batch_step_equals_single_steps(pairs):
    """The lockstep step on a list of pairs, one of them at rest (R = 0, so
    its timestep is infinite and the Euler update is skipped): each listed
    pair's motion and velocity equal its own step's; the others are not
    written. A list that is not the whole stack takes its tail as many
    pairs at a time as the gather buffer holds: one, two, or all."""
    u, vel, g = _fields()
    u[1], vel[1], g[1] = 0.0, 0.0, 0.0
    step = make_fluid_batch_step(0.25, 0.0, 0.66)
    single = make_fluid_step(0.25, 0.0, 0.66)
    for chunk in (1, 2, 4):
        u_out, vel_out = torch.full_like(u, 5.0), torch.full_like(vel, 6.0)
        step(u, vel, g, Pairs(pairs, 4), vel_out, u_out, torch.empty((chunk, 2) + SHAPE))
        for p in range(4):
            if p in pairs:
                want_u, want_vel = single(u[p], vel[p], g[p])
                assert torch.equal(u_out[p], want_u) and torch.equal(vel_out[p], want_vel)
            else:
                assert (u_out[p] == 5.0).all() and (vel_out[p] == 6.0).all()
        assert torch.equal(u_out[1], u[1])


@pytest.mark.parametrize("pairs", [[0, 1, 2, 3], [3, 0]])
def test_batched_derive_plain_version_equals_single_calls(pairs):
    """U2 batched: pair ``p``'s ``g`` from ``irefs[p]`` and the ``z``-th
    warped image (list order), equal to its own ``derive``; pairs not
    listed are not written."""
    rng = np.random.default_rng(3)
    irefs = torch.from_numpy(rng.uniform(0, 1, (4,) + SHAPE).astype(np.float32))
    warped = torch.from_numpy(rng.uniform(0, 1, (len(pairs),) + SHAPE).astype(np.float32))
    out = derive_batch(irefs, warped, pairs, torch.full((4, 3) + SHAPE, 9.0))
    for z, p in enumerate(pairs):
        assert torch.equal(out[p], derive(irefs[p], warped[z]))
    for p in set(range(4)) - set(pairs):
        assert (out[p] == 9.0).all()
