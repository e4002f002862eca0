"""The reference ``Logger``'s stop rule (``src/Logger.cpp:32-58``), in numpy
float32 on the host, for every level loop of the port.

A loop hands it the step and previous-field magnitudes of the iterations
it ran since its last decision (``k`` of them for a blocked kernel, one for
a loop that reads every iteration), each normalised as the loop's own sums
are, and takes back the iterations to keep and whether the stop fired. It
works element by element on numpy float32 scalars: a block holds at most a
few iterations, and the host's turnaround between blocks is the pace of the
coarse levels. ``iteration_stops`` is the same rule for one iteration of
many pairs at once, on numpy arrays (the lockstep fluid loop reads
hundreds of pairs an iteration).
"""

from __future__ import annotations

import numpy as np


def relative_errors(d, p) -> list:
    """``d / p`` in float32 for each iteration, 0 where the previous-field
    magnitude ``p`` is 0 (``d`` and ``p``: sequences of float32 scalars)."""
    return [np.float32(0) if pt == 0 else dt / pt for dt, pt in zip(d, p)]


def block_stop(errs, it: int, niter: int, tol) -> tuple[int, bool]:
    """``(n_take, stopped)`` for the errors of iterations ``it .. it +
    len(errs) - 1``: the stop fires at the first error below ``tol`` past
    iteration 1 and before ``niter``, and the iterations up to it are
    taken; without a stop, all of them up to the ``niter`` cap."""
    for t, e in enumerate(errs):
        if it + t >= niter:
            return t, False
        if e < tol and it + t > 1:
            return t + 1, True
    return len(errs), False


def iteration_stops(d: np.ndarray, p: np.ndarray, it: int, niter: int, tol):
    """``relative_errors`` and ``block_stop`` of one iteration ``it`` (below
    ``niter``) of many pairs: ``d``, ``p`` float32 arrays of the pairs'
    magnitudes; returns their errors, each bit-equal to
    ``relative_errors``'s, and whether each pair stops there."""
    errs = np.where(p == 0, np.float32(0), d / np.where(p == 0, np.float32(1), p))
    return errs, (errs < tol) & (it > 1) & (it < niter)
