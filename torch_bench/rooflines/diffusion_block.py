"""B1, the blocked Horn-Schunck kernel (``csrc/diffusion_block.cu``): the
least time its launches need.

A launch runs ``block_k`` Jacobi iterations of a level over device memory
once: it reads u (2 planes, 8 B/px) and the stacked derivatives (3 planes,
12 B/px) and writes u (8 B/px), 28 B/px. A solve of ``iterations``
iterations launches it ``ceil(iterations / block_k)`` times (a stop
inside a block recomputes the taken steps with another kernel). Each byte
is counted once a launch, whatever the kernel reads again; its operations
(about 20 a pixel and iteration) stay under the bandwidth bound.
"""

from __future__ import annotations

KERNELS = ("diffusion_block_kernel",)
BYTES_PER_PIXEL = 28


def pyramid_dims(dims, nscales: int):
    """The level sizes, ``dims / 2^s`` truncated."""
    return [(int(dims[0] / (2.0 ** s)), int(dims[1] / (2.0 ** s))) for s in range(nscales + 1)]


def launches(iterations: int, block_k: int) -> int:
    return -(-iterations // block_k)


def bytes_moved(solves, dims, nscales: int, block_k: int) -> int:
    """Bytes the launches of ``solves`` (``(scale, iterations, regrids)``
    of every solve of every request) need at least."""
    levels = pyramid_dims(dims, nscales)
    return sum(launches(it, block_k) * BYTES_PER_PIXEL * levels[s][0] * levels[s][1]
               for s, it, _ in solves)


def least_seconds(solves, dims, nscales: int, block_k: int, hbm_bytes_per_s: float) -> float:
    return bytes_moved(solves, dims, nscales, block_k) / hbm_bytes_per_s
