"""Backward bilinear warping, motion composition and the exponential map
(PyTorch port of ``opticalflow2d_tpu.ops.warp``).

- ``warp2d``: reference ``src/Image.cpp:119-182``
- ``compose`` (= ``Motion::accumulate``): reference ``src/Motion.cpp:113-178``
- ``expmap``: scaling and squaring, reference ``src/Motion.cpp:253-277``

``warp2d`` and ``compose`` live with their CUDA kernel in
``kernels.warp_fused``: a CUDA tensor goes to the gather kernel, a CPU
tensor to its plain version. The JAX package's roll path, its displacement
bound and the ``lax.cond`` fallback stood in for the gather a TPU lacks and
have no counterpart here.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from opticalflow2d_tpu_torch.kernels.warp_fused import compose, warp2d
from opticalflow2d_tpu_torch.ops.reduce import motion_maxabs

__all__ = ["warp2d", "compose", "expmap", "expmap_nsq", "static_expmap_nsq"]


def static_expmap_nsq(maxabs_bound: float) -> int:
    """Squaring count from a static bound on ``maxabs(u)``: the formula of
    ``expmap_nsq`` applied to the bound, in double precision. For bounds
    ``<= 0.5`` it is 0, and since the count is monotone in maxabs, the exp
    map of every field within the bound is then the identity (the
    reference's early return for nsquares == 0, ``src/Motion.cpp:257-260``)."""
    if maxabs_bound <= 0:
        return 0
    return max(0, math.ceil(1.0 + math.log2(maxabs_bound)))


def expmap_nsq(m: float) -> int:
    """``max(0, ceil(1 + log2(max(m, tiny))))`` in float32 for a measured
    ``m = maxabs(u)``, 0 for ``m == 0``: the count the JAX package computes
    on the device, here on the host from one read of ``m``."""
    m32 = np.float32(m)
    if not m32 > 0:
        return 0
    nsq = np.ceil(np.float32(1.0) + np.log2(max(m32, np.finfo(np.float32).tiny)))
    return max(0, int(nsq))


def expmap(u: torch.Tensor, maxabs_bug: bool = False) -> torch.Tensor:
    """Exponential map of a velocity field ``u [2, nx, ny]`` by scaling and
    squaring (reference ``src/Motion.cpp:253-277``): ``u`` is scaled by
    ``2^-nsq`` and self-composed ``nsq`` times, ``nsq = expmap_nsq(m)``.
    ``maxabs_bug=True`` measures ``m`` with the reference's
    ``Motion::maxabs`` defect (``src/Motion.cpp:54``, the y component
    twice), which changes the number of squarings. The squarings are
    ``compose`` calls, so they run the gather kernel on CUDA; ``m`` costs
    one host read."""
    nsq = expmap_nsq(float(motion_maxabs(u, bug=maxabs_bug)))
    if nsq == 0:
        return u
    v = u * float(2.0 ** -nsq)
    for _ in range(nsq):
        v = compose(v, v)
    return v
