"""The comparison that decides a run's ``correct``: the answers of sampled
requests of the window against the plain reference's for the same pairs.

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
