"""The comparison that decides a run's ``correct``: the answers of sampled
requests of the window against the plain reference's for the same pairs.

A request holds ``P`` pairs (the traffic's ``pairs_per_request``): for
``P`` 1 an entry is ``(iref, imov)`` and an answer ``(motion [2, nx, ny],
warped [nx, ny], solves)``; for more, every tensor has a leading pair axis
and ``solves`` lists each pair's solves in turn, pair 0 first, the same
number for each. Every pair of a checked request is compared on its own.

For each checked pair the numbers are the largest gap between the
program's motion field and the reference's (px), between the warped
moving images (intensity, images in [0, 1]), and between the iteration and
regrid counts of each level and refinement. Each has its limit in the
configuration's file (``limits``); ``PERF.md`` gives the readings each
was set from.

The control is the reference with every stored field (images, pyramid
levels, derivatives, motion and velocity) rounded to bfloat16, its
arithmetic in float32: the configuration states float32, and storing the
fields in bfloat16 is the step below it that would tempt a faster
program.
"""

from __future__ import annotations

import torch

from torch_bench import cells
from torch_bench.reference import common

NAMES = ("motion_gap_px", "warp_gap", "iters_gap", "regrids_gap")


def bf16_store(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(x.dtype)


def reference_answer(config: dict, iref, imov, control: bool = False):
    """``(motion, warped, solves)`` of the plain reference (or the
    control) for one pair."""
    ref = cells.reference(config)
    store = bf16_store if control else (lambda x: x)
    motion, solves = ref.register(store(iref), store(imov), config["settings"], store)
    warped = common.warp(store(imov), motion)
    return motion, warped, [tuple(s) for s in solves]


def check_answer(answer, pairs: int, dims) -> None:
    """Refuse an answer that does not hold ``pairs`` pairs of ``dims``."""
    motion, warped, solves = answer
    shapes = (tuple(motion.shape), tuple(warped.shape))
    if (shapes != (cells.stack_shape(pairs, dims, 2), cells.stack_shape(pairs, dims))
            or not solves or len(solves) % pairs):
        raise ValueError(f"an answer of {pairs} pair(s) of {list(dims)} holds motion and warped "
                         f"of {shapes[0]} and {shapes[1]} and {len(solves)} solves")


def split(request: tuple, pairs: int) -> list:
    """The tuple of each pair of a request, pair 0 first: an entry ``(iref,
    imov)`` or an answer ``(motion, warped, solves)``. For one pair a
    request, ``request`` itself; for more, pair ``i``'s slice of each
    tensor and the ``i``-th of ``pairs`` equal runs of a list."""
    if pairs == 1:
        return [request]

    def part(x, i):
        if isinstance(x, torch.Tensor):
            return x[i]
        n = len(x) // pairs
        return x[i * n:(i + 1) * n]

    return [tuple(part(x, i) for x in request) for i in range(pairs)]


def gaps(answer, expected) -> dict:
    """The numbers of one pair: ``answer`` and ``expected`` are
    ``(motion, warped, solves)``."""
    (m, w, s), (m_ref, w_ref, s_ref) = answer, expected
    if len(s) != len(s_ref):
        return {n: float("inf") for n in NAMES}
    return {
        "motion_gap_px": float((m.double() - m_ref.double()).abs().max()),
        "warp_gap": float((w.double() - w_ref.double()).abs().max()),
        "iters_gap": float(max(abs(a[1] - b[1]) for a, b in zip(s, s_ref))),
        "regrids_gap": float(max(abs(a[2] - b[2]) for a, b in zip(s, s_ref))),
    }


def worst(readings: list) -> dict:
    """The largest of each number over the checked pairs (NaN counts as
    the largest)."""
    out = {}
    for n in NAMES:
        vals = [r[n] for r in readings]
        out[n] = float("nan") if any(v != v for v in vals) else max(vals, default=float("nan"))
    return out


def judge(numbers: dict, limits: dict) -> bool:
    """True when every number lies within its limit (a missing or NaN
    number never does)."""
    return all(numbers[n] is not None and numbers[n] <= limits[n] for n in limits)
