"""The lockstep demons driver of ``register_batch`` (``engine.registration.
_solve_level_demons_batch``) and the plain version of B10's pair axis
(``thirion_onepass_batch``), on the CPU.

Every pair of a stack registered in lockstep equals its own ``register``,
bit for bit: motion, coarse motion, Logger errors and iteration counts, for
Thirion by composition and by addition and for diffeomorphic demons in the
exp map's identity regime. The stack's four pairs stop apart, and the
tests assert that they do: one at the earliest iteration the Logger allows
(3), one on the stop at the cap, two at the cap without a stop.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import opticalflow2d_tpu_torch as T
from _torch_helpers import tiled_pair
from opticalflow2d_tpu_torch.engine import registration
from opticalflow2d_tpu_torch.kernels._build import Pairs
from opticalflow2d_tpu_torch.kernels.demons_onepass import (
    thirion_onepass, thirion_onepass_batch, thirion_onepass_batch_ref)
from opticalflow2d_tpu_torch.parallel import register_batch
from opticalflow2d_tpu_torch.parallel.batch import _resolve_impl
from opticalflow2d_tpu_torch.solvers.demons import (
    demons_route, make_demons_batch_step, make_demons_step)
from opticalflow2d_tpu_torch.utils import profiling

SHAPE = (48, 40)
SHIFTS = ((0.1, 0.05), (1.5, -0.8), (2.2, -1.4), (4.5, -3.0))
# A tolerance at which the pairs' Logger errors (about 1/t) stop them apart
# within the cap of 7 at the coarse level's first solve: pair 0 at 3, pair
# 1 by the stop at the cap, pairs 2 and 3 at the cap without it.
STOPS = dict(niter=(7, 7), nscales=1, nrefine=2, convergence_tol=0.15)
CONFIGS = {
    "thirion_composition": T.RegConfig(method=T.Method.THIRIONS_DEMONS, **STOPS),
    "thirion_addition": T.RegConfig(method=T.Method.THIRIONS_DEMONS,
                                    accumulation=T.MotionAccumulation.ADDITION, **STOPS),
    "diffeomorphic_identity": T.RegConfig(method=T.Method.DIFFEOMORPHIC_DEMONS, **STOPS),
}


@pytest.fixture(scope="module")
def demons_stacks():
    pairs = [tiled_pair(*SHAPE, shift=s, seed=i) for i, s in enumerate(SHIFTS)]
    return np.stack([p[0] for p in pairs]), np.stack([p[1] for p in pairs])


@pytest.fixture(scope="module")
def demons_singles(demons_stacks):
    return {name: [T.register(demons_stacks[0][i], demons_stacks[1][i], cfg, device="cpu")
                   for i in range(len(SHIFTS))]
            for name, cfg in CONFIGS.items()}


def _assert_each_demons_register(got, singles) -> None:
    """Every pair of the lockstep result as its own ``register``, bit for
    bit: motion, coarse motion, iteration counts, errors; no regrids."""
    for i, one in enumerate(singles):
        assert torch.equal(got.motion[i], one.motion)
        assert torch.equal(got.coarse_motion[i], one.coarse_motion)
        assert [int(t.iterations[i]) for t in got.traces] == [t.iterations for t in one.traces]
        for a, b in zip(got.traces, one.traces):
            assert torch.equal(a.errors[i], b.errors)
            assert int(a.regrids[i]) == 0 and int(a.fallbacks[i]) == 0


def test_the_demons_configs_take_the_onepass_route():
    for cfg in CONFIGS.values():
        route = demons_route(cfg.sigma_i, cfg.sigma_x, cfg.kernelwidth,
                             cfg.method == T.Method.DIFFEOMORPHIC_DEMONS)
        assert route == "onepass"
        assert registration.lockstep_refusal(cfg, SHAPE) is None
        assert _resolve_impl(cfg, "auto", SHAPE) == "vmap"


@pytest.mark.parametrize("name", list(CONFIGS))
@pytest.mark.parametrize("impl", ["vmap", "auto"])
def test_lockstep_demons_equals_each_register(demons_stacks, demons_singles, name, impl):
    cfg = CONFIGS[name]
    got = register_batch(*demons_stacks, cfg, impl=impl, device="cpu")
    singles = demons_singles[name]
    _assert_each_demons_register(got, singles)
    # The pairs stop apart: at 3, by the stop at the cap, and at the cap.
    first = [one.traces[0] for one in singles]
    its = [t.iterations for t in first]
    assert its[0] == 3 and its[2] == its[3] == cfg.niter[1]
    assert its[1] == cfg.niter[1] and 0 < float(first[1].errors[-1]) < cfg.convergence_tol
    assert float(first[3].errors[-1]) >= cfg.convergence_tol
    assert len({tuple(t.iterations for t in one.traces) for one in singles}) > 1


def test_lockstep_demons_reads_once_an_iteration(demons_stacks, demons_singles,
                                                 monkeypatch):
    """One launch of B10's pair axis and one host read an iteration for all
    the pairs still iterating: as many as the slowest pair's iterations in
    each solve, one pair fewer as each stops."""
    launched = []
    original = registration.make_demons_batch_step

    def counting(*args, **kw):
        step = original(*args, **kw)

        def counted(u, irefs, iaux, pairs, out):
            launched.append(len(pairs))
            return step(u, irefs, iaux, pairs, out)

        return counted

    monkeypatch.setattr(registration, "make_demons_batch_step", counting)
    got = register_batch(*demons_stacks, CONFIGS["thirion_composition"], impl="vmap",
                         device="cpu")
    _assert_each_demons_register(got, demons_singles["thirion_composition"])
    assert len(launched) == sum(int(t.iterations.max()) for t in got.traces)
    assert sum(launched) == sum(int(t.iterations.sum()) for t in got.traces)
    assert max(launched) == len(SHIFTS) and min(launched) < len(SHIFTS)


def test_lockstep_demons_spans(demons_stacks):
    """A ``solve`` span a refinement with its ``derive`` (the warp) and
    ``compose``, and inside it a ``read`` span of site ``demons_batch`` an
    iteration, carrying the number of pairs it reads."""
    cfg = CONFIGS["thirion_composition"]
    profiling.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        got = register_batch(*demons_stacks, cfg, impl="vmap", device="cpu")
    records = profiling.records()
    profiling.clear()
    names = [r[0] for r in records]
    solves = [i for i, n in enumerate(names) if n == "solve"]
    assert len(solves) == len(got.traces)
    for i, t in zip(solves, got.traces):
        kids = [r for r in records if r[3] == i]
        assert [r[0] for r in kids] == (["derive"] + ["read"] * int(t.iterations.max())
                                        + ["compose"])
        assert records[i][5] == {"scale": t.scale, "refine": records[i][5]["refine"],
                                 "nx": SHAPE[0] >> t.scale, "ny": SHAPE[1] >> t.scale}
        reads = [r[5] for r in kids if r[0] == "read"]
        want = [int((t.iterations > k).sum()) for k in range(int(t.iterations.max()))]
        assert reads == [{"site": "demons_batch", "pairs": n} for n in want]


def test_lockstep_demons_without_iterations(demons_stacks):
    """``niter`` 0 at a level: no launch, no read, the motion composed with
    a zero increment, as ``register`` does it."""
    cfg = T.RegConfig(method=T.Method.THIRIONS_DEMONS, niter=(0, 4), nscales=1)
    got = register_batch(*demons_stacks, cfg, impl="vmap", device="cpu")
    for i in range(len(SHIFTS)):
        one = T.register(demons_stacks[0][i], demons_stacks[1][i], cfg, device="cpu")
        assert torch.equal(got.motion[i], one.motion)
        assert [int(t.iterations[i]) for t in got.traces] == [t.iterations for t in one.traces]
    assert got.traces[-1].errors.shape == (len(SHIFTS), 0)


def test_lockstep_demons_warm_start_leaves_the_initial_motions_alone(demons_stacks):
    """``initial_motions`` seeds each pair as ``register(initial_motion=...)``
    does, and the driver writes into no tensor of the caller's: with one
    level, the solve starts from the caller's fields."""
    cfg = T.RegConfig(method=T.Method.THIRIONS_DEMONS, niter=(6,), nrefine=2)
    warm = torch.zeros((len(SHIFTS), 2) + SHAPE)
    warm[:, 0], warm[:, 1] = -1.0, 1.0
    kept = warm.clone()
    got = register_batch(*demons_stacks, cfg, impl="vmap", initial_motions=warm, device="cpu")
    assert torch.equal(warm, kept)
    for i in range(len(SHIFTS)):
        one = T.register(demons_stacks[0][i], demons_stacks[1][i], cfg, initial_motion=warm[i],
                         device="cpu")
        assert torch.equal(got.motion[i], one.motion)
        assert [int(t.iterations[i]) for t in got.traces] == [t.iterations for t in one.traces]


# Demons routes without a pair axis: diffeomorphic outside the exp map's
# identity regime (B11, the exp map, B12), and the op chain.
NO_PAIR_AXIS = {
    "two_kernel": (dict(method=T.Method.DIFFEOMORPHIC_DEMONS, sigma_i=0.25, sigma_x=1.0),
                   "B11, the exp map and B12"),
    "op_chain_flatwrap": (dict(method=T.Method.THIRIONS_DEMONS,
                               compat=T.CompatFlags(conv_flatwrap=True)), "op chain"),
}


@pytest.mark.parametrize("case", list(NO_PAIR_AXIS))
def test_demons_routes_without_a_pair_axis_map(demons_stacks, case):
    """``vmap`` refuses them, naming the missing pair axes; ``auto`` maps,
    each pair as its own ``register``."""
    overrides, reason = NO_PAIR_AXIS[case]
    cfg = T.RegConfig(niter=(3,), **overrides)
    assert _resolve_impl(cfg, "auto", SHAPE) == "map"
    with pytest.raises(NotImplementedError, match=reason):
        register_batch(*demons_stacks, cfg, impl="vmap", device="cpu")
    with pytest.raises(ValueError, match="onepass route"):
        make_demons_batch_step(cfg.sigma_i, cfg.sigma_x, cfg.sigma_diffusion, cfg.sigma_fluid,
                               cfg.kernelwidth, cfg.method == T.Method.DIFFEOMORPHIC_DEMONS,
                               conv_flatwrap=cfg.compat.conv_flatwrap)
    refs, movs = demons_stacks[0][:2], demons_stacks[1][:2]
    got = register_batch(refs, movs, cfg, impl="auto", device="cpu")
    for i in range(2):
        assert torch.equal(got.motion[i], T.register(refs[i], movs[i], cfg,
                                                     device="cpu").motion)


# --- B10's pair axis, plain version --------------------------------------------

def _demons_fields(n=4, seed=0):
    rng = np.random.default_rng(seed)
    iaux = torch.from_numpy(rng.uniform(0, 1, (n,) + SHAPE).astype(np.float32))
    irefs = torch.from_numpy(rng.uniform(0, 1, (n,) + SHAPE).astype(np.float32))
    u = torch.from_numpy(rng.normal(0, 1.5, (n, 2) + SHAPE).astype(np.float32))
    return iaux, irefs, u


@pytest.mark.parametrize("pairs", [[0, 1, 2, 3], [3, 1], [2]])
@pytest.mark.parametrize("addition", [False, True])
def test_batched_onepass_plain_version_equals_single_calls(pairs, addition):
    """Each listed pair's field and Logger sums equal its own single call,
    the sums in list order; pairs not listed are not written."""
    iaux, irefs, u = _demons_fields()
    args = (1.0, 0.25, 2.0, 1.5, 5, addition)
    fill = torch.full_like(u, float("nan"))
    out, sums = thirion_onepass_batch(iaux, irefs, u, *args, pairs=pairs, out=fill.clone())
    assert sums.shape == (len(pairs), 2)
    for z, p in enumerate(pairs):
        one, one_sums = thirion_onepass(iaux[p], irefs[p], u[p], *args, with_errors=True)
        assert torch.equal(out[p], one) and torch.equal(sums[z], one_sums)
    for p in set(range(4)) - set(pairs):
        assert bool(out[p].isnan().all())
    ref_out, ref_sums = thirion_onepass_batch_ref(iaux, irefs, u, *args, pairs=Pairs(pairs, 4))
    assert torch.equal(ref_sums, sums)
    assert all(torch.equal(ref_out[p], out[p]) for p in pairs)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_demons_batch_step_equals_the_single_step(name):
    """The lockstep step on a list of pairs against ``make_demons_step``
    with its sums, pair by pair; the others are not written."""
    cfg = CONFIGS[name]
    iaux, irefs, u = _demons_fields(seed=1)
    kw = dict(diffeomorphic=cfg.method == T.Method.DIFFEOMORPHIC_DEMONS,
              accumulation=cfg.accumulation)
    params = (cfg.sigma_i, cfg.sigma_x, cfg.sigma_diffusion, cfg.sigma_fluid, cfg.kernelwidth)
    batch = make_demons_batch_step(*params, **kw)
    single = make_demons_step(*params, with_errors=True, **kw)
    out = torch.full_like(u, 5.0)
    sums = batch(u, irefs, iaux, Pairs([3, 0], 4), out)
    for z, p in enumerate([3, 0]):
        want, want_sums = single(u[p], irefs[p], iaux[p])
        assert torch.equal(out[p], want) and torch.equal(sums[z], want_sums)
    assert (out[1] == 5.0).all() and (out[2] == 5.0).all()


def test_lockstep_demons_verbose_lines(demons_stacks, capsys):
    """With ``verbose_stream``, one line an iteration a pair, tagged with the pair,
    as the map prints it without the tag."""
    cfg = T.RegConfig(method=T.Method.THIRIONS_DEMONS, niter=(4,), verbose_stream=True)
    got = register_batch(*demons_stacks, cfg, impl="vmap", device="cpu")
    lines = [ln for ln in capsys.readouterr().out.splitlines() if "relative error" in ln]
    assert len(lines) == int(got.traces[0].iterations.sum())
    assert lines[0].startswith("  [pair 0] [scale 0] iteration 1: relative error ")
    assert sum(ln.startswith("  [pair 3] ") for ln in lines) == int(got.traces[0].iterations[3])
