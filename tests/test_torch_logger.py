"""The reference Logger's stop rule (``engine.logger``), which every level
loop of the port calls: the relative errors in float32 with 0 where the
previous magnitude is 0, the stop past iteration 1 and before the cap, and
the iterations a block keeps."""

import numpy as np
import pytest

from opticalflow2d_tpu_torch.engine.logger import block_stop, iteration_stops, relative_errors

F32 = np.float32
TOL = F32(1e-3)


def test_relative_errors_are_float32_and_zero_where_the_previous_magnitude_is():
    d = np.array([3.0, 5.0, 0.0, 7.0], F32)
    p = np.array([7.0, 0.0, 0.0, 3.0], F32)
    with np.errstate(all="raise"):
        e = relative_errors(d, p)
    assert all(type(x) is np.float32 for x in e)
    assert e == [F32(3.0) / F32(7.0), 0.0, 0.0, F32(7.0) / F32(3.0)]
    # The blocked loops' vectorized form, bit for bit.
    vec = np.where(p == 0, F32(0), d / np.where(p == 0, F32(1), p))
    assert np.array(e, F32).tobytes() == vec.tobytes()
    # One iteration's scalars, as the fluid and demons loops pass them.
    assert relative_errors([F32(1.0)], [F32(0.0)]) == [0.0]
    assert relative_errors([F32(1.0)], [F32(3.0)]) == [F32(1.0) / F32(3.0)]


@pytest.mark.parametrize("errs,it,niter,want", [
    ([0.0, 0.0, 1.0, 1.0], 0, 50, (4, False)),    # iterations 0 and 1 never stop
    ([1.0, 1.0, 0.0, 1.0], 0, 50, (3, True)),     # the first past 1 below tol
    ([1.0, 0.0, 0.0, 1.0], 0, 50, (3, True)),     # iteration 1 ignored, 2 taken
    ([1.0, 1.0, 1.0, 0.0], 8, 50, (4, True)),     # at the block's last iteration
    ([1.0, 0.0005, 1.0, 0.0], 8, 50, (2, True)),  # the first of two stops
    ([1.0, 1.0, 1.0, 1.0], 8, 10, (2, False)),    # the cap inside the block
    ([1.0, 1.0, 0.0, 1.0], 8, 10, (2, False)),    # a stop past the cap is not one
    ([1.0, 0.0, 1.0, 1.0], 8, 10, (2, True)),     # a stop at the cap's last iteration
    ([1.0, 1.0, 1.0, 1.0], 8, 12, (4, False)),    # the cap at the block's end
    ([F32(TOL), 1.0, 1.0, 1.0], 8, 50, (4, False)),  # tol itself does not stop
])
def test_block_stop(errs, it, niter, want):
    assert block_stop(np.array(errs, F32), it, niter, TOL) == want


@pytest.mark.parametrize("it,err,want", [
    (0, 0.0, (1, False)), (1, 0.0, (1, False)), (2, 0.0, (1, True)), (2, 1.0, (1, False)),
])
def test_a_single_iteration_is_a_block_of_one(it, err, want):
    assert block_stop([F32(err)], it, 10, TOL) == want


@pytest.mark.parametrize("seed", range(4))
def test_a_block_decides_as_its_iterations_one_at_a_time(seed):
    """On random sums, zeros among them, a block of k keeps the iterations
    that a loop deciding each iteration on its own error would run, and
    the vectorized rule the blocked loops wrote out before (numpy over the
    block) decides alike."""
    rng = np.random.default_rng(seed)
    for _ in range(200):
        k = int(rng.integers(1, 9))
        niter = int(rng.integers(1, 40))
        it = int(rng.integers(0, niter))
        d = (rng.random(k) * 2e-3).astype(F32) * (rng.random(k) > 0.2)
        p = (rng.random(k) * 2).astype(F32) * (rng.random(k) > 0.2)
        e = relative_errors(d, p)
        ran, stopped = 0, False
        while ran < k and it + ran < niter and not stopped:
            one = F32(0.0) if p[ran] == 0 else d[ran] / p[ran]
            stopped = bool(one < TOL) and it + ran > 1
            ran += 1
        assert block_stop(e, it, niter, TOL) == (ran, stopped)
        vec = np.where(p == 0, F32(0), d / np.where(p == 0, F32(1), p))
        assert np.array(e, F32).tobytes() == vec.tobytes()
        its = it + np.arange(k)
        stop = (vec < TOL) & (its > 1) & (its < niter)
        want = (int(np.argmax(stop)) + 1, True) if stop.any() else (min(niter - it, k), False)
        assert block_stop(e, it, niter, TOL) == want


@pytest.mark.parametrize("seed", range(3))
def test_one_iteration_of_many_pairs_decides_as_each_pair_alone(seed):
    """``iteration_stops`` (the lockstep fluid loop's read of hundreds of
    pairs): each pair's error bit-equal to ``relative_errors``'s and its
    stop ``block_stop``'s for a block of one, zeros and ``tol`` itself
    among the magnitudes."""
    rng = np.random.default_rng(seed)
    d = (rng.random(300) * 2e-3).astype(F32) * (rng.random(300) > 0.2)
    p = (rng.random(300) * 2).astype(F32) * (rng.random(300) > 0.2)
    d[:3], p[:3] = TOL, F32(1.0)
    for it in (0, 1, 2, 7):
        errs, stops = iteration_stops(d, p, it, 8, TOL)
        assert errs.dtype == F32
        for k in range(300):
            [one] = relative_errors([d[k]], [p[k]])
            assert errs[k].tobytes() == F32(one).tobytes()
            assert (1, bool(stops[k])) == block_stop([one], it, 8, TOL)
        assert stops.any() == (it > 1)
