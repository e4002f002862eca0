"""B10, the one-pass Thirion demons iteration (``csrc/demons_onepass.cu``,
single or by its pair axis): the least time its launches need.

An iteration of a demons solve on the ``"onepass"`` route launches B10 once
for its pair: it reads the refinement-warped moving image ``iaux`` (4 B/px),
the reference (4 B/px) and the estimate u (8 B/px), and writes the new
estimate (8 B/px), 24 B/px. Its operations (about 173 a pixel at kernelwidth
5, without multiply-adds) stay under the bandwidth bound. Each byte is
counted once a launch, whatever the kernel reads again (the warp's and the
compose's gathers, the halos), and the small kernel that adds its Logger
partials is left out. The lockstep loop launches it once an iteration for
all the pairs still iterating, so the bytes are those of every
pair-iteration the solves report.
"""

from __future__ import annotations

from torch_bench.rooflines.diffusion_block import pyramid_dims

BYTES_PER_PIXEL = 24


def bytes_moved(solves, dims, nscales: int) -> int:
    """Bytes the launches of ``solves`` (``(scale, iterations, regrids)``
    of every solve of every pair and request) need at least."""
    levels = pyramid_dims(dims, nscales)
    return sum(it * BYTES_PER_PIXEL * levels[s][0] * levels[s][1] for s, it, _ in solves)


def least_seconds(solves, dims, nscales: int, hbm_bytes_per_s: float) -> float:
    return bytes_moved(solves, dims, nscales) / hbm_bytes_per_s
