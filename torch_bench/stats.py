"""The benchmark's own arithmetic on results: the percentile of a list and
the SSD reduction of a registration."""

from __future__ import annotations

import math

import torch


def percentile(values, q: float) -> float:
    """The ``q``-th percentile (0-100) of ``values``, interpolated linearly
    between the two nearest ranks of the sorted list (rank ``q/100 (n-1)``,
    counted from 0)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("no values")
    rank = q / 100.0 * (len(xs) - 1)
    lo = math.floor(rank)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (rank - lo)


def ssd_reduction(iref: torch.Tensor, imov: torch.Tensor, warped: torch.Tensor) -> float:
    """``1 - SSD(Iref, warped) / SSD(Iref, Imov)``: 1 for a perfect
    registration, 0 for none."""
    before = float(((iref.double() - imov.double()) ** 2).sum())
    after = float(((iref.double() - warped.double()) ** 2).sum())
    return 1.0 - after / before if before > 0 else 0.0
