"""The blocked level loop (``engine.registration._solve_level_blocked``),
on a stack of one pair (``register``) and of three in lockstep
(``register_batch``), and its lookahead: block n + 1 is launched before
block n's Logger sums are read, and dropped when no pair of it is left.
The loop must give the motion, errors and counts of the plain lockstep
loop that reads each block before launching the next
(``_torch_helpers.plain_solve_level_blocked``), bit for bit, and
``LOOKAHEAD`` must count the blocks launched ahead and dropped."""

import pytest
import torch

import opticalflow2d_tpu_torch as T
from _torch_helpers import plain_solve_level_blocked, tiled_pair
from opticalflow2d_tpu_torch.engine import registration

TOL = 1e-3


@pytest.fixture
def lookahead():
    """``LOOKAHEAD`` zeroed for the test, and restored after it."""
    saved = dict(registration.LOOKAHEAD)
    registration.LOOKAHEAD.update(ahead=0, discarded=0)
    yield registration.LOOKAHEAD
    registration.LOOKAHEAD.update(saved)


# The scripted fields hold the iterations done in steps of STEP: a power
# of two, exact in float32, small enough that the compose of a zero motion
# with the level's increment samples inside the image and gives the
# increment itself.
STEP = 2.0 ** -10
SHAPE = (16, 16)


def _scripted(k: int, stops):
    """A block and a recompute whose Logger errors follow a script, pair by
    pair: every iteration's error is 1 but at iterations 0 and 1 (0, which
    the Logger ignores there) and at ``stops[p]`` (0, below tol). A block
    writes only the listed pairs, into a stack of NaN where it is given
    none, so a read of a field nobody wrote raises. Returns ``(block_fn,
    recompute_fn, starts)``, ``starts[p]`` the iteration each block
    launched for pair ``p`` began at."""
    starts = [[] for _ in stops]

    def block_fn(src, g, pairs, dst):
        dst = torch.full_like(src, float("nan")) if dst is None else dst
        sums = []
        for p in pairs:
            t0 = round(float(src[p, 0, 0, 0]) / STEP)
            starts[p].append(t0)
            sums.append([[0.0 if t in (0, 1, stops[p]) else 1.0, 1.0]
                         for t in range(t0, t0 + k)])
            dst[p] = src[p] + k * STEP
        return dst, torch.tensor(sums, dtype=src.dtype)

    def recompute_fn(src, g, pairs, n, final, other):
        for p in pairs:
            final[p] = src[p] + n * STEP

    return block_fn, recompute_fn, starts


def _expected(k: int, niter: int, its: int) -> tuple:
    """``(blocks read, discarded)`` of a solve whose slowest pair ran
    ``its`` iterations of ``niter``: a block is dropped where the stop
    landed in a block that ends before the cap, since only then was the
    next one launched."""
    blocks = -(-its // k)
    return blocks, int(its > 0 and blocks * k < niter)


def _check_scripted(lookahead, k: int, niter: int, stops) -> None:
    """The driver against the plain loop on a stack of ``len(stops)``
    pairs: the same fields, errors and counts, bit for bit, each pair's
    increment holding its own count, each pair's blocks launched on the
    plain loop's fields and on one more where its share of a block ahead
    was dropped, and ``LOOKAHEAD`` counting the launches ahead of the
    slowest pair."""
    b = len(stops)
    cfg = T.RegConfig(method=T.Method.DIFFUSION, niter=(niter,), nrefine=2,
                      convergence_tol=TOL)
    pairs = [tiled_pair(*SHAPE, seed=p) for p in range(b)]
    irefs, imovs = (torch.stack([torch.from_numpy(x[i]) for x in pairs]) for i in (0, 1))
    u0 = torch.zeros((b, 2) + SHAPE)
    block_fn, recompute_fn, starts = _scripted(k, stops)
    u, traces = registration._solve_level_blocked(u0, irefs, imovs, cfg, niter, 0, k,
                                                  block_fn, recompute_fn, batch=b > 1)
    plain_fn, plain_recompute, plain_starts = _scripted(k, stops)
    u_plain, traces_plain = plain_solve_level_blocked(u0, irefs, imovs, cfg, niter, 0, k,
                                                      plain_fn, plain_recompute, batch=b > 1)
    assert torch.equal(u, u_plain)
    want = [niter if stop is None or stop >= niter else stop + 1 for stop in stops]
    # Each refinement adds its constant increment, inside the image.
    for p in range(b):
        inner = u[p, :, :-1, :-1]
        assert torch.equal(inner, torch.full_like(inner, cfg.nrefine * want[p] * STEP))
    for t, tp in zip(traces, traces_plain, strict=True):
        assert t.iterations.tolist() == tp.iterations.tolist() == want
        assert torch.equal(t.errors, tp.errors) and t.errors.dtype == torch.float32
    for p in range(b):
        blocks, dropped = _expected(k, niter, want[p])
        solve = list(range(0, blocks * k, k))
        assert plain_starts[p] == solve * cfg.nrefine
        assert starts[p] == (solve + [blocks * k] * dropped) * cfg.nrefine
    blocks, discarded = _expected(k, niter, max(want))
    assert lookahead == {"ahead": cfg.nrefine * max(blocks - 1 + discarded, 0),
                         "discarded": cfg.nrefine * discarded}


# (k, niter, iteration whose error falls below tol, or None)
SCRIPTS = [
    (8, 50, 11),     # inside a block
    (8, 50, 15),     # at a block's last iteration
    (8, 16, 7),      # at block 0's last iteration, block 1 reaching the cap
    (8, 24, None),   # the cap, niter a multiple of k
    (8, 21, None),   # the cap, niter not a multiple of k
    (8, 21, 17),     # inside the block that reaches the cap: nothing ahead
    (8, 21, 20),     # at the cap's own iteration
    (8, 5, None),    # one block, below k
    (8, 0, None),    # no iteration
    (1, 10, 5),      # k = 1 (curvature, the spectral and lexicographic solves)
    (1, 10, None),
    (4, 30, 9),      # red-black elastic's k
    (4, 30, 11),
    (4, 30, None),
]


@pytest.mark.parametrize("k,niter,stop", SCRIPTS)
def test_the_lookahead_equals_the_plain_loop_on_scripted_errors(lookahead, k, niter, stop):
    _check_scripted(lookahead, k, niter, [stop])


# Three pairs in lockstep, (k, niter, each pair's stop): one inside a
# block, one at a block's last iteration, one at the cap, in varied orders.
LOCKSTEP = [
    (8, 50, (11, 15, None)),   # the slowest pair at the cap: nothing dropped
    (8, 45, (None, 23, 4)),    # ragged cap; pair 2 at block 0's end, pair 1 at block 2's
    (8, 50, (11, 15, 35)),     # the slowest stops inside a block: its block ahead dropped
    (8, 50, (10, 13, None)),   # two stops inside one block, at different counts
    (4, 30, (9, 11, None)),    # k = 4: inside and at the end of the same block
    (1, 10, (5, 3, None)),     # k = 1
    (8, 0, (None, None, None)),
]


@pytest.mark.parametrize("k,niter,stops", LOCKSTEP)
def test_the_lockstep_lookahead_equals_the_plain_loop_on_scripted_errors(lookahead, k, niter,
                                                                         stops):
    _check_scripted(lookahead, k, niter, list(stops))


# method, settings, niter by scale (finest first), the loop's k: chosen
# so that the solves of the 64 x 64 pair stop inside a block, at a block's
# end, in the block that reaches the cap and at the cap, niter a multiple
# of k or not.
REGISTRATIONS = {
    "diffusion": (T.Method.DIFFUSION, dict(alpha=0.1), (150, 75, 45), 8),
    "curvature": (T.Method.CURVATURE, dict(alpha=10.0, tau=5.0), (20, 15, 200), 1),
    "elastic_redblack": (T.Method.ELASTIC, dict(mu=0.25, lam=0.0), (150, 75, 300), 4),
    "elastic_redblack_capped": (T.Method.ELASTIC, dict(mu=0.25, lam=0.0), (30, 22, 130), 4),
}


@pytest.mark.parametrize("name", sorted(REGISTRATIONS))
def test_register_equals_the_plain_loop_bit_for_bit(lookahead, monkeypatch, name):
    method, settings, niter, k = REGISTRATIONS[name]
    cfg = T.RegConfig(method=method, niter=niter, nscales=2, nrefine=2, **settings)
    iref, imov = tiled_pair(64, 64)
    got = T.register(iref, imov, cfg, device="cpu")
    counted = dict(lookahead)
    monkeypatch.setattr(registration, "_solve_level_blocked", plain_solve_level_blocked)
    want = T.register(iref, imov, cfg, device="cpu")
    assert torch.equal(got.motion, want.motion)
    assert [(t.scale, t.iterations) for t in got.traces] == \
        [(t.scale, t.iterations) for t in want.traces]
    for t, tw in zip(got.traces, want.traces, strict=True):
        assert torch.equal(t.errors, tw.errors)
    per_solve = [_expected(k, niter[t.scale], t.iterations) for t in got.traces]
    assert counted == {"ahead": sum(b - 1 + d for b, d in per_solve),
                       "discarded": sum(d for _, d in per_solve)}
    # The cases the settings were chosen for.
    stops = [(t.iterations, niter[t.scale]) for t in got.traces]
    assert any(its < n for its, n in stops) and any(its == n for its, n in stops)
    if name == "elastic_redblack_capped":
        # A stop inside the block that reaches the cap: nothing to drop.
        assert any(its < n and d == 0 for (its, n), (_, d) in zip(stops, per_solve))
    else:
        assert counted["discarded"] > 0
    if name == "diffusion":
        assert any(its < n and its % k == 0 for its, n in stops)     # at a block's end
        assert any(its < n and its % k for its, n in stops)          # inside a block
        assert any(its == n and n % k for its, n in stops)           # the cap, ragged



@pytest.mark.parametrize("name", ["curvature", "diffusion", "elastic_redblack"])
def test_register_batch_equals_the_plain_loop_bit_for_bit(lookahead, monkeypatch, name):
    """The lockstep driver of ``register_batch`` on three pairs that stop
    apart, against the plain loop: bits, counts and ``LOOKAHEAD``, whose
    launches ahead follow each solve's slowest pair."""
    from opticalflow2d_tpu_torch.parallel import register_batch

    method, settings, niter, k = REGISTRATIONS[name]
    cfg = T.RegConfig(method=method, niter=niter, nscales=2, nrefine=2, **settings)
    pairs = [tiled_pair(64, 64, shift=shift, seed=p)
             for p, shift in enumerate([(1.5, -0.8), (0.75, -1.6), (3.0, -0.25)])]
    irefs, imovs = (torch.stack([torch.from_numpy(x[i]) for x in pairs]) for i in (0, 1))
    got = register_batch(irefs, imovs, cfg, impl="vmap", device="cpu")
    counted = dict(lookahead)
    monkeypatch.setattr(registration, "_solve_level_blocked", plain_solve_level_blocked)
    want = register_batch(irefs, imovs, cfg, impl="vmap", device="cpu")
    assert torch.equal(got.motion, want.motion)
    for t, tw in zip(got.traces, want.traces, strict=True):
        assert torch.equal(t.iterations, tw.iterations) and torch.equal(t.errors, tw.errors)
    per_solve = [_expected(k, niter[t.scale], int(t.iterations.max())) for t in got.traces]
    assert counted == {"ahead": sum(b - 1 + d for b, d in per_solve),
                       "discarded": sum(d for _, d in per_solve)}
    assert any(len(set(t.iterations.tolist())) == 3 for t in got.traces)
