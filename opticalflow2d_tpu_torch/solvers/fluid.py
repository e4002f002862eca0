"""Viscous-fluid solver (Christensen): an SOR sweep on the velocity field,
the material-derivative increment and an adaptive explicit-Euler timestep
(PyTorch port of ``opticalflow2d_tpu.solvers.fluid``).

Per iteration (reference ``src/regularization/OpticalFlow/
OpticalFlowFluid.cpp:123-140``):
  1. force at the current motion,
  2. one SOR sweep of the Navier-Lame system on the persistent velocity
     field (warm-started across iterations and refinements),
  3. increment ``R = v - (du/dx) v_x - (du/dy) v_y`` (``:60-90``),
  4. ``dt = dumax / maxabs(R)`` (``:92-95``); if ``dt >= timestep_skip`` the
     integration is skipped (``:135-137``), else ``u += R * dt``.

Steps 1-3 and ``max |R|^2`` are one kernel on CUDA (``kernels.fluid_fused``,
red-black ordering); the lexicographic ordering runs the plain chain on any
device. The tail stays on the device as plain tensor ops on 0-d tensors, so
a step makes no host read. ``maxabs_bug=True`` reproduces the reference's
``Motion::maxabs`` defect, which changes the timestep sequence.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from opticalflow2d_tpu_torch.kernels.fluid_fused import fluid_iter, fluid_iter_ref
from opticalflow2d_tpu_torch.ops.reduce import sqrt_rounded


def make_fluid_step(mu: float, lam: float, omega: float, dumax: float = 0.65,
                    timestep_skip: float = 65.0, maxabs_bug: bool = False,
                    reference_stencil: bool = True, sor_ordering: str = "redblack"):
    """Build the fluid step ``(u, velocity, g) -> (u, velocity)`` with
    ``g = stack_derivs(grad_i, it)``."""
    if sor_ordering not in ("redblack", "lexicographic"):
        raise ValueError(f"unknown SOR ordering {sor_ordering!r}")
    dumax32 = float(np.float32(dumax))
    skip32 = float(np.float32(timestep_skip))

    def step(u: torch.Tensor, velocity: torch.Tensor,
             g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        if sor_ordering == "redblack":
            velocity, r, maxsq = fluid_iter(u, velocity, g, mu, lam, omega,
                                            reference_stencil, maxabs_bug)
        else:
            velocity, r, maxsq = fluid_iter_ref(u, velocity, g, mu, lam, omega,
                                                reference_stencil, maxabs_bug, sor_ordering)
        # An f32 division, as JAX's: m == 0 gives dt = inf, a skip.
        dt = torch.full_like(maxsq, dumax32) / sqrt_rounded(maxsq)
        do_step = dt < skip32
        u = torch.where(do_step, u + r * torch.where(do_step, dt, 0.0), u)
        return u, velocity

    return step
