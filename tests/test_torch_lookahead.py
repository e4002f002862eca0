"""The blocked level loop's lookahead (``engine.registration.
_solve_level_blocked``): block n + 1 is launched before block n's Logger
sums are read, and dropped when the stop lands in block n. The loop must
give the motion, errors and counts of the plain loop that reads each block
before launching the next (``_torch_helpers.plain_solve_level_blocked``),
bit for bit, and ``LOOKAHEAD`` must count the blocks launched ahead and
dropped."""

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


def _scripted(k: int, stop):
    """A block and a recompute whose Logger errors follow a script: every
    iteration's error is 1 but at iterations 0 and 1 (0, which the Logger
    ignores there) and at ``stop`` (0, below tol). The field holds the
    number of iterations done, so a block's start is readable from its
    input. Returns ``(block_fn, recompute_fn, starts)``, ``starts`` the
    iteration each launched block began at."""
    starts = []

    def block_fn(u, g):
        t0 = int(u[0, 0, 0])
        starts.append(t0)
        err = [0.0 if t in (0, 1, stop) else 1.0 for t in range(t0, t0 + k)]
        return u + k, torch.tensor([[e, 1.0] for e in err], dtype=u.dtype)

    def recompute_fn(u, g, n):
        return u + n

    return block_fn, recompute_fn, starts


def _expected(k: int, niter: int, its: int) -> tuple:
    """``(blocks read, discarded)`` of a solve that ran ``its`` iterations
    of ``niter``: a block is dropped where the stop landed in a block that
    ends before the cap, since only then was the next one launched."""
    blocks = -(-its // k)
    return blocks, int(its > 0 and blocks * k < niter)


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
    cfg = T.RegConfig(method=T.Method.DIFFUSION, niter=(niter,), nrefine=2,
                      convergence_tol=TOL)
    iref, imov = (torch.from_numpy(x) for x in tiled_pair(8, 8))
    u0 = torch.zeros((2, 8, 8))
    block_fn, recompute_fn, starts = _scripted(k, stop)
    u, traces = registration._solve_level_blocked(u0, iref, imov, cfg, niter, 0, k,
                                                  block_fn, recompute_fn)
    plain_fn, plain_recompute, plain_starts = _scripted(k, stop)
    u_plain, traces_plain = plain_solve_level_blocked(u0, iref, imov, cfg, niter, 0, k,
                                                      plain_fn, plain_recompute)
    assert torch.equal(u, u_plain)
    want_its = niter if stop is None or stop >= niter else stop + 1
    for t, tp in zip(traces, traces_plain, strict=True):
        assert t.iterations == tp.iterations == want_its
        assert torch.equal(t.errors, tp.errors) and t.errors.dtype == torch.float32
    blocks, discarded = _expected(k, niter, want_its)
    # Each refinement launches the plain loop's blocks, on the same fields,
    # and one more after the last where it drops one.
    solve = list(range(0, blocks * k, k))
    assert plain_starts == solve * cfg.nrefine
    assert starts == (solve + [blocks * k] * discarded) * cfg.nrefine
    assert lookahead == {"ahead": cfg.nrefine * max(blocks - 1 + discarded, 0),
                         "discarded": cfg.nrefine * discarded}


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

