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
device. With a ``spectral_solve`` (``solvers.navier_lame``) the velocity is
the exact Navier-Lame solution of the current force instead of one sweep,
and the material derivative and ``max |R|^2`` are plain tensor ops, as in
JAX, where the fused kernel is not taken either (``fluid.py:55-57``). The
tail stays on the device as plain tensor ops on 0-d tensors, so a step
makes no host read. ``maxabs_bug=True`` reproduces the reference's
``Motion::maxabs`` defect, which changes the timestep sequence.

``make_fluid_batch_step`` is the step on the listed pairs of a stack (B7's
pair axis, red-black), the Euler tail on each pair's own timestep: the
lockstep driver's step, each pair's bits those of ``make_fluid_step``.

``make_fluid_two_pass_step`` is the same step in two passes that never
store R (red-black only): the sweep with ``max |R|^2``, the timestep gate
on device scalars, then the Euler pass, which recomputes R. It gives the
same bits as ``make_fluid_step``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from opticalflow2d_tpu_torch.kernels._build import Pairs
from opticalflow2d_tpu_torch.kernels.fluid_fused import (
    fluid_euler,
    fluid_iter,
    fluid_iter_batch,
    fluid_iter_ref,
    fluid_sweep_max,
    material_derivative,
)
from opticalflow2d_tpu_torch.ops.reduce import motion_max_normsq, sqrt_rounded
from opticalflow2d_tpu_torch.solvers.base import Derivatives, lssd_force


def _timestep(maxsq: torch.Tensor, dumax32: float) -> torch.Tensor:
    """``dt = dumax / max|R|``, an f32 division as JAX's: ``maxsq == 0``
    gives ``dt = inf``, a skip."""
    return torch.full_like(maxsq, dumax32) / sqrt_rounded(maxsq)


def make_fluid_step(mu: float, lam: float, omega: float, dumax: float = 0.65,
                    timestep_skip: float = 65.0, maxabs_bug: bool = False,
                    reference_stencil: bool = True, sor_ordering: str = "redblack",
                    spectral_solve=None):
    """Build the fluid step ``(u, velocity, g) -> (u, velocity)`` with
    ``g = stack_derivs(grad_i, it)``; ``spectral_solve(f) -> velocity``
    replaces the SOR sweep when given."""
    if sor_ordering not in ("redblack", "lexicographic"):
        raise ValueError(f"unknown SOR ordering {sor_ordering!r}")
    dumax32 = float(np.float32(dumax))
    skip32 = float(np.float32(timestep_skip))

    def step(u: torch.Tensor, velocity: torch.Tensor,
             g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        if spectral_solve is not None:
            velocity = spectral_solve(lssd_force(Derivatives(g[:2], g[2]), u))
            r = material_derivative(u, velocity)
            maxsq = motion_max_normsq(r, maxabs_bug)
        elif sor_ordering == "redblack":
            velocity, r, maxsq = fluid_iter(u, velocity, g, mu, lam, omega,
                                            reference_stencil, maxabs_bug)
        else:
            velocity, r, maxsq = fluid_iter_ref(u, velocity, g, mu, lam, omega,
                                                reference_stencil, maxabs_bug, sor_ordering)
        dt = _timestep(maxsq, dumax32)
        do_step = dt < skip32
        u = torch.where(do_step, u + r * torch.where(do_step, dt, 0.0), u)
        return u, velocity

    return step


def make_fluid_batch_step(mu: float, lam: float, omega: float, dumax: float = 0.65,
                          timestep_skip: float = 65.0, maxabs_bug: bool = False,
                          reference_stencil: bool = True):
    """Build the red-black fluid step on the listed pairs of a stack,
    ``(u, velocity, g, pairs, vel_out, u_out, scratch) -> None``: ``u``,
    ``velocity [B, 2, nx, ny]``, ``g [B, 3, nx, ny]``, ``pairs`` a ``Pairs``
    of the stack, ``scratch [C, 2, nx, ny]``. It writes each listed pair's
    velocity into ``vel_out[p]`` and its new motion into ``u_out[p]`` and
    leaves the other pairs as they are. One launch of B7 for all the pairs
    (``fluid_iter_batch``), then ``make_fluid_step``'s tail on the ``[n, 1,
    1, 1]`` timesteps, so each pair's motion and velocity equal its own
    step's bit for bit. The tail runs in place on B7's R, which it takes in
    list order; where the list is not the whole stack, on the listed pairs'
    motion gathered to match, ``C`` pairs at a time through ``scratch``."""
    dumax32 = float(np.float32(dumax))
    skip32 = float(np.float32(timestep_skip))

    def step(u: torch.Tensor, velocity: torch.Tensor, g: torch.Tensor, pairs: Pairs,
             vel_out: torch.Tensor, u_out: torch.Tensor, scratch: torch.Tensor) -> None:
        _, r, maxsq = fluid_iter_batch(u, velocity, g, mu, lam, omega, reference_stencil,
                                       maxabs_bug, pairs, vel_out)
        dt = _timestep(maxsq, dumax32)[:, None, None, None]
        do_step = dt < skip32
        # u + R dt, as u + r * where(do_step, dt, 0) rounds it (an add
        # commutes exactly), then the gate; each pair's R is scratch.
        r.mul_(torch.where(do_step, dt, 0.0))
        if pairs.whole:
            r.add_(u)
            torch.where(do_step, r, u, out=u_out)
            return
        idx = pairs.on(u.device, torch.int64)
        for z in range(0, len(idx), scratch.shape[0]):
            i = idx[z:z + scratch.shape[0]]
            mine = torch.index_select(u, 0, i, out=scratch[:len(i)])
            rz = r[z:z + len(i)]
            rz.add_(mine)
            torch.where(do_step[z:z + len(i)], rz, mine, out=rz)
            u_out.index_copy_(0, i, rz)

    return step


def make_fluid_two_pass_step(mu: float, lam: float, omega: float, dumax: float = 0.65,
                             timestep_skip: float = 65.0, maxabs_bug: bool = False,
                             reference_stencil: bool = True):
    """Build the two-pass fluid step ``(u, velocity, g) -> (u, velocity)``
    (red-black), the port of the JAX package's ``fluid_2pass`` iteration
    (``engine/registration.py:1104-1123``): the sweep and ``max |R|^2``,
    the gate ``where(dt < timestep_skip, dt, 0)`` (``fluid_gate``, :878),
    the Euler pass. No host read, and R is never stored."""
    dumax32 = float(np.float32(dumax))
    skip32 = float(np.float32(timestep_skip))

    def step(u: torch.Tensor, velocity: torch.Tensor,
             g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        velocity, maxsq = fluid_sweep_max(u, velocity, g, mu, lam, omega, reference_stencil,
                                          maxabs_bug)
        dt = _timestep(maxsq, dumax32)
        gate = torch.where(dt < skip32, dt, 0.0)
        return fluid_euler(u, velocity, gate), velocity

    return step
