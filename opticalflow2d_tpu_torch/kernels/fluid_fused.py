"""The fusable part of one viscous-fluid iteration in one pass over device
memory (CUDA ``csrc/fluid_iter.cu``, the counterpart of
``opticalflow2d_tpu/pallas_kernels/fluid_fused.py::fluid_iter_pallas``):

    read (u, vel, g) -> force(u) -> red half-sweep -> black half-sweep on vel
        -> material derivative R -> write (vel', R), max |R|^2

(reference ``src/regularization/OpticalFlow/OpticalFlowFluid.cpp:123-140``).
The timestep ``dt = dumax / sqrt(max |R|^2)`` and the gated Euler update are
global and stay outside (``solvers.fluid.make_fluid_step``). max is exact in
any order, so ``sqrt(maxsq)`` equals ``motion_maxabs`` of the kernel's R.

The two-pass iteration of large grids never stores R
(``fluid_sweep_max_pallas`` and ``fluid_euler_pallas`` there):
``fluid_sweep_max`` is the same pass writing vel' and ``max |R|^2`` only,
and ``fluid_euler`` (CUDA ``csrc/fluid_euler.cu``) recomputes R from u and
vel', bit for bit, and applies the gated Euler step.
"""

from __future__ import annotations

from typing import Tuple

import torch

from opticalflow2d_tpu_torch import kernels
from opticalflow2d_tpu_torch.kernels import _build
from opticalflow2d_tpu_torch.ops.grid import partial_x, partial_y
from opticalflow2d_tpu_torch.ops.reduce import motion_max_normsq
from opticalflow2d_tpu_torch.solvers.base import Derivatives, lssd_force
from opticalflow2d_tpu_torch.solvers.elastic import sor_scalars, sor_sweep


def material_derivative(u: torch.Tensor, vel: torch.Tensor) -> torch.Tensor:
    """``R_c = v_c - (d u_c/dx) v_x - (d u_c/dy) v_y``
    (``OpticalFlowFluid.cpp:60-90``)."""
    return vel - partial_x(u) * vel[0:1] - partial_y(u) * vel[1:2]


def fluid_iter_ref(u: torch.Tensor, vel: torch.Tensor, g: torch.Tensor, mu: float,
                   lam: float, omega: float, reference_stencil: bool = True,
                   maxabs_bug: bool = False, ordering: str = "redblack"
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel, the JAX package's jnp chain:
    ``lssd_force``, ``sor_sweep`` on the velocity, the material derivative,
    ``max |R|^2``. Returns ``(vel', R, maxsq)``. ``ordering`` also takes
    the lexicographic sweep, which has no kernel. ``maxabs_bug`` measures
    ``|R|`` with the reference's ``Motion::maxabs`` defect."""
    f = lssd_force(Derivatives(g[:2], g[2]), u)
    vel = sor_sweep(vel, f, mu, lam, omega, reference_stencil, ordering)
    r = material_derivative(u, vel)
    return vel, r, motion_max_normsq(r, maxabs_bug)


def _check_fields(u: torch.Tensor, vel: torch.Tensor, nx: int, ny: int) -> None:
    if u.device.type != "cuda":
        raise ValueError(f"no fluid kernel for device {u.device}")
    _build.check_cuda("u", u, (2, nx, ny), u.device)
    _build.check_cuda("vel", vel, (2, nx, ny), u.device)
    if min(nx, ny) < 2:
        raise ValueError(f"the fluid kernels need nx, ny >= 2, got {(nx, ny)}")


def _check_fluid(u: torch.Tensor, vel: torch.Tensor, g: torch.Tensor):
    """The checks of the sweep kernels (B7, B8); returns the library."""
    _, nx, ny = u.shape
    _check_fields(u, vel, nx, ny)
    _build.check_cuda("g", g, (3, nx, ny), u.device)
    lib = _build.load()
    _build.check_smem(lib.of2d_fluid_iter_smem_bytes(), u.device, "the fluid iteration")
    return lib


def fluid_iter(u: torch.Tensor, vel: torch.Tensor, g: torch.Tensor, mu: float, lam: float,
               omega: float, reference_stencil: bool = True, maxabs_bug: bool = False
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Force, red-black sweep, material derivative and ``max |R|^2`` of one
    fluid iteration for the motion ``u``, the velocity ``vel``
    (``[2, nx, ny]``) and ``g = stack_derivs(grad_i, it)``; returns
    ``(vel', R, maxsq)`` with ``maxsq`` a 0-d tensor on the fields' device.
    The plain version on the CPU, the kernel on CUDA."""
    if _build.on_cpu(u, vel, g):
        return fluid_iter_ref(u, vel, g, mu, lam, omega, reference_stencil, maxabs_bug)
    lib = _check_fluid(u, vel, g)
    _, nx, ny = u.shape
    vel_out = torch.empty_like(vel)
    r = torch.empty_like(vel)
    partials = torch.empty(lib.of2d_sor_nblocks(nx, ny), dtype=u.dtype, device=u.device)
    maxsq = torch.empty((), dtype=u.dtype, device=u.device)
    _build.launch(
        "of2d_fluid_iter", u.device, u.data_ptr(), vel.data_ptr(), g.data_ptr(),
        vel_out.data_ptr(), r.data_ptr(), partials.data_ptr(), maxsq.data_ptr(), nx, ny,
        *sor_scalars(mu, lam, omega), int(reference_stencil), int(maxabs_bug),
    )
    kernels.LAUNCHES["fluid_iter"] += 1
    return vel_out, r, maxsq


def fluid_sweep_max_ref(u: torch.Tensor, vel: torch.Tensor, g: torch.Tensor, mu: float,
                        lam: float, omega: float, reference_stencil: bool = True,
                        maxabs_bug: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the sweep-and-max pass: ``fluid_iter_ref``
    (red-black) without returning R. Returns ``(vel', maxsq)``."""
    vel, _, maxsq = fluid_iter_ref(u, vel, g, mu, lam, omega, reference_stencil, maxabs_bug)
    return vel, maxsq


def fluid_sweep_max(u: torch.Tensor, vel: torch.Tensor, g: torch.Tensor, mu: float,
                    lam: float, omega: float, reference_stencil: bool = True,
                    maxabs_bug: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Force, red-black sweep and ``max |R|^2`` of one fluid iteration, with
    R kept out of memory; returns ``(vel', maxsq)``, ``maxsq`` a 0-d tensor
    on the fields' device, bit-equal to ``fluid_iter``'s. The plain version
    on the CPU, the kernel on CUDA."""
    if _build.on_cpu(u, vel, g):
        return fluid_sweep_max_ref(u, vel, g, mu, lam, omega, reference_stencil, maxabs_bug)
    lib = _check_fluid(u, vel, g)
    _, nx, ny = u.shape
    vel_out = torch.empty_like(vel)
    partials = torch.empty(lib.of2d_sor_nblocks(nx, ny), dtype=u.dtype, device=u.device)
    maxsq = torch.empty((), dtype=u.dtype, device=u.device)
    _build.launch(
        "of2d_fluid_sweep_max", u.device, u.data_ptr(), vel.data_ptr(), g.data_ptr(),
        vel_out.data_ptr(), partials.data_ptr(), maxsq.data_ptr(), nx, ny,
        *sor_scalars(mu, lam, omega), int(reference_stencil), int(maxabs_bug),
    )
    kernels.LAUNCHES["fluid_sweep_max"] += 1
    return vel_out, maxsq


def fluid_euler_ref(u: torch.Tensor, vel: torch.Tensor, gate: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the Euler pass: R from ``(u, vel)`` and
    ``where(gate > 0, u + R * gate, u)``."""
    r = material_derivative(u, vel)
    return torch.where(gate > 0, u + r * gate, u)


def fluid_euler(u: torch.Tensor, vel: torch.Tensor, gate: torch.Tensor) -> torch.Tensor:
    """The gated Euler step ``u' = where(gate > 0, u + R * gate, u)`` with R
    recomputed from the motion ``u`` and the swept velocity ``vel``
    (``[2, nx, ny]``); ``gate`` is a 0-d tensor on the fields' device, read
    there by the kernel. The plain version on the CPU, the kernel on CUDA."""
    if _build.on_cpu(u, vel, gate):
        return fluid_euler_ref(u, vel, gate)
    _, nx, ny = u.shape
    _check_fields(u, vel, nx, ny)
    _build.check_cuda("gate", gate, (), u.device)
    out = torch.empty_like(u)
    _build.launch("of2d_fluid_euler", u.device, u.data_ptr(), vel.data_ptr(), gate.data_ptr(),
                  out.data_ptr(), nx, ny)
    kernels.LAUNCHES["fluid_euler"] += 1
    return out
