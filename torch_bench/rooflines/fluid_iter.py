"""The fluid iteration's kernels: the least time their launches need.

Each iteration of a fluid solve launches the fluid metrics B5
(``csrc/logger_norms.cu``: reads u_new and u_prev, 16 B/px) and one step.
A level whose larger extent exceeds 8192 takes the two-pass step: B8, the
sweep and ``max |R|^2`` (``csrc/fluid_iter.cu`` without R: reads u, the
velocity and the three derivative planes, writes the velocity, 36 B/px),
then B9, the Euler pass (``csrc/fluid_euler.cu``: reads u and the velocity,
writes u, 24 B/px). Any other level takes the one-pass step B7 (B8's reads
and writes and R besides, 44 B/px). Each launch also runs a small kernel
that reduces its per-block partials, whose bytes are left out. Each byte is
counted once a launch, whatever the kernel reads again; a skipped timestep
still launches the Euler pass. The iterations of a solve count every step,
a regrid's included.
"""

from __future__ import annotations

from torch_bench.rooflines.diffusion_block import pyramid_dims

KERNELS = ("fluid_metrics_kernel", "sum_partials_kernel", "min_partials_kernel",
           "fluid_iter_kernel", "max_partials_kernel", "fluid_euler_kernel")
TWO_PASS_MIN_EXTENT = 8192
B5, B7, B8, B9 = 16, 44, 36, 24


def bytes_per_iteration(nx: int, ny: int) -> int:
    step = B8 + B9 if max(nx, ny) > TWO_PASS_MIN_EXTENT else B7
    return (B5 + step) * nx * ny


def bytes_moved(solves, dims, nscales: int) -> int:
    """Bytes the launches of ``solves`` (``(scale, iterations, regrids)``
    of every solve of every request) need at least."""
    levels = pyramid_dims(dims, nscales)
    return sum(it * bytes_per_iteration(*levels[s]) for s, it, _ in solves)


def least_seconds(solves, dims, nscales: int, hbm_bytes_per_s: float) -> float:
    return bytes_moved(solves, dims, nscales) / hbm_bytes_per_s
