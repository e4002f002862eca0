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

``fluid_iter_batch`` is ``fluid_iter`` on the listed pairs of a stack in
one launch (the lockstep fluid driver, ``engine.registration``): each
pair's vel' at its place in the stack, its R and ``max |R|^2`` in list
order.

``fluid_iter_strip`` is ``fluid_iter`` on one strip of the strip-parallel
driver (``parallel.spatial``), pre-padded with ``FLUID_PAD`` halo rows a
side: the colours, the interior and R's one-sided borders are the image's,
and its ``max |R|^2`` is the strip's, which the driver maxes over strips.

A thread block holds one output tile of ``FLUID_PLAN`` with a halo of 2
cells in shared memory, 9 planes (u, the velocity twice, g): 32 rows by 64
columns, 88,192 B, two blocks an SM. The max partials have one entry per tile
(``fluid_tiles``).
"""

from __future__ import annotations

from typing import Tuple

import torch

from opticalflow2d_tpu_torch import kernels
from opticalflow2d_tpu_torch.kernels import _build
from opticalflow2d_tpu_torch.ops.grid import partial_x, partial_x_rows, partial_y
from opticalflow2d_tpu_torch.ops.reduce import motion_max_normsq
from opticalflow2d_tpu_torch.solvers.base import Derivatives, lssd_force
from opticalflow2d_tpu_torch.solvers.elastic import sor_scalars, sor_sweep


# Halo rows a side the strip-parallel driver gives the strip kernel: the
# TPU kernel's _PAD (fluid_fused.py:52); the sweep's cone needs 2.
FLUID_PAD = 8

# The kernels' tile (csrc/fluid_stages.cuh kFluidPlan): output tile rows,
# columns and threads of a block.
FLUID_PLAN = (32, 64, 512)
FLUID_HALO = 2  # the sweep's cone: the black half reads red cells that read one further


def fluid_smem_floats(tx: int, ty: int, threads: int) -> int:
    """Floats of shared memory of one block on plan ``(tx, ty, threads)``:
    u, the velocity twice and g (9 planes) on the tile extended by
    ``FLUID_HALO`` a side, and one max per warp."""
    return 9 * (tx + 2 * FLUID_HALO) * (ty + 2 * FLUID_HALO) + threads // 32


def fluid_tiles(nx: int, ny: int) -> int:
    """Thread blocks, and entries of the max partials, of a launch over
    ``nx`` (a strip's ``nxl``) rows."""
    tx, ty, _ = FLUID_PLAN
    return -(-nx // tx) * -(-ny // ty)


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


def fluid_iter_batch_ref(u: torch.Tensor, vel: torch.Tensor, g: torch.Tensor, mu: float,
                         lam: float, omega: float, reference_stencil: bool = True,
                         maxabs_bug: bool = False, pairs=None,
                         vel_out: torch.Tensor | None = None
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the batched kernel: ``fluid_iter_ref`` on
    each listed pair, its vel' into ``vel_out[p]``; R ``[n_pairs, 2, nx,
    ny]`` and maxsq ``[n_pairs]`` in list order."""
    pairs = _build.as_pairs(pairs, u.shape[0])
    vel_out = torch.zeros_like(vel) if vel_out is None else vel_out
    rs, maxsqs = [], []
    for p in pairs:
        vel_out[p], r, maxsq = fluid_iter_ref(u[p], vel[p], g[p], mu, lam, omega,
                                              reference_stencil, maxabs_bug)
        rs.append(r)
        maxsqs.append(maxsq)
    return vel_out, torch.stack(rs), torch.stack(maxsqs)


def fluid_iter_batch(u: torch.Tensor, vel: torch.Tensor, g: torch.Tensor, mu: float,
                     lam: float, omega: float, reference_stencil: bool = True,
                     maxabs_bug: bool = False, pairs=None, vel_out: torch.Tensor | None = None
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``fluid_iter`` on the listed pairs of a stack in one launch: ``u,
    vel [B, 2, nx, ny]``, ``g [B, 3, nx, ny]``, ``pairs`` distinct indices
    in ``[0, B)`` (or ``_build.Pairs``). Writes pair ``p``'s vel' into
    ``vel_out[p]`` and leaves the other pairs of ``vel_out`` as they are
    (zeros when it is None); returns ``(vel_out, R [n_pairs, 2, nx, ny],
    maxsq [n_pairs])``, R and maxsq in the order of ``pairs``. Each pair's
    vel', R and maxsq equal its own ``fluid_iter`` call's. The plain
    version on the CPU, the kernel on CUDA."""
    if _build.on_cpu(u, vel, g, *(() if vel_out is None else (vel_out,))):
        return fluid_iter_batch_ref(u, vel, g, mu, lam, omega, reference_stencil, maxabs_bug,
                                    pairs, vel_out)
    if u.device.type != "cuda":
        raise ValueError(f"no fluid kernel for device {u.device}")
    if u.dim() != 4 or u.shape[1] != 2:
        raise ValueError(f"u must be [B, 2, nx, ny], got {tuple(u.shape)}")
    b, _, nx, ny = u.shape
    _build.check_cuda("u", u, (b, 2, nx, ny), u.device)
    _build.check_cuda("vel", vel, (b, 2, nx, ny), u.device)
    _build.check_cuda("g", g, (b, 3, nx, ny), u.device)
    if min(nx, ny) < 2:
        raise ValueError(f"the fluid kernels need nx, ny >= 2, got {(nx, ny)}")
    pairs = _build.as_pairs(pairs, b)
    if vel_out is None:
        vel_out = torch.zeros_like(vel)
    _build.check_out(vel_out, vel, u, vel, g)
    lib = _build.load()
    _build.check_smem(lib.of2d_fluid_iter_smem_bytes(), u.device, "the fluid iteration")
    n = len(pairs)
    r = torch.empty((n, 2, nx, ny), dtype=u.dtype, device=u.device)
    partials = torch.empty((n, lib.of2d_sor_nblocks(nx, ny)), dtype=u.dtype, device=u.device)
    maxsq = torch.empty(n, dtype=u.dtype, device=u.device)
    _build.launch(
        "of2d_fluid_iter_batch", u.device, u.data_ptr(), vel.data_ptr(), g.data_ptr(),
        vel_out.data_ptr(), r.data_ptr(), partials.data_ptr(), maxsq.data_ptr(),
        pairs.on(u.device).data_ptr(), n, nx, ny, *sor_scalars(mu, lam, omega),
        int(reference_stencil), int(maxabs_bug),
    )
    kernels.LAUNCHES["fluid_iter_batch"] += 1
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


def fluid_iter_strip_ref(u_pad: torch.Tensor, vel_pad: torch.Tensor, g_pad: torch.Tensor,
                         row0: int, nx_glob: int, mu: float, lam: float, omega: float,
                         reference_stencil: bool = True, maxabs_bug: bool = False,
                         pad: int = FLUID_PAD
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the strip kernel: ``fluid_iter_ref`` on the
    padded strip with the image's colours, interior and borders; returns
    the strip's ``(vel' [2, nxl, ny], R, maxsq)``."""
    nxl = _build.strip_rows(u_pad, pad)
    f = lssd_force(Derivatives(g_pad[:2], g_pad[2]), u_pad)
    vel = sor_sweep(vel_pad, f, mu, lam, omega, reference_stencil, "redblack", row0 - pad,
                    nx_glob)[:, pad:pad + nxl]
    u = u_pad[:, pad - 1:pad + nxl + 1]
    gi = torch.arange(row0, row0 + nxl, device=u.device)[:, None]
    r = vel - partial_x_rows(u, gi, nx_glob) * vel[0:1] - partial_y(u[:, 1:-1]) * vel[1:2]
    return vel.contiguous(), r, motion_max_normsq(r, maxabs_bug)


def fluid_iter_strip(u_pad: torch.Tensor, vel_pad: torch.Tensor, g_pad: torch.Tensor,
                     row0: int, nx_glob: int, mu: float, lam: float, omega: float,
                     reference_stencil: bool = True, maxabs_bug: bool = False,
                     pad: int = FLUID_PAD) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``fluid_iter`` on one strip: ``u_pad, vel_pad [2, nxl + 2 pad, ny]``
    and ``g_pad [3, ...]`` carry ``pad`` halo rows a side (zeros beyond the
    image), ``row0`` is the global index of the strip's first row and
    ``nx_glob`` the image's rows. Returns the strip's ``(vel', R, maxsq)``.
    The plain version on the CPU, the kernel on CUDA."""
    if _build.on_cpu(u_pad, vel_pad, g_pad):
        return fluid_iter_strip_ref(u_pad, vel_pad, g_pad, row0, nx_glob, mu, lam, omega,
                                    reference_stencil, maxabs_bug, pad)
    if u_pad.device.type != "cuda":
        raise ValueError(f"no fluid kernel for device {u_pad.device}")
    nxl, ny = _build.strip_rows(u_pad, pad), u_pad.shape[-1]
    for name, t, c in (("u_pad", u_pad, 2), ("vel_pad", vel_pad, 2), ("g_pad", g_pad, 3)):
        _build.check_cuda(name, t, (c, nxl + 2 * pad, ny), u_pad.device)
    _build.check_strip(row0, nxl, nx_glob)
    if pad < 2 or min(nx_glob, ny) < 2:
        raise ValueError(f"the fluid strip kernel needs pad >= 2 and nx, ny >= 2, got "
                         f"pad {pad}, {(nx_glob, ny)}")
    lib = _build.load()
    _build.check_smem(lib.of2d_fluid_iter_smem_bytes(), u_pad.device, "the fluid iteration")
    vel_out = torch.empty((2, nxl, ny), dtype=u_pad.dtype, device=u_pad.device)
    r = torch.empty_like(vel_out)
    partials = torch.empty(lib.of2d_sor_nblocks(nxl, ny), dtype=u_pad.dtype,
                           device=u_pad.device)
    maxsq = torch.empty((), dtype=u_pad.dtype, device=u_pad.device)
    _build.launch(
        "of2d_fluid_iter_strip", u_pad.device, u_pad.data_ptr(), vel_pad.data_ptr(),
        g_pad.data_ptr(), vel_out.data_ptr(), r.data_ptr(), partials.data_ptr(),
        maxsq.data_ptr(), nxl, ny, pad, row0, nx_glob, *sor_scalars(mu, lam, omega),
        int(reference_stencil), int(maxabs_bug),
    )
    kernels.LAUNCHES["fluid_iter_strip"] += 1
    return vel_out, r, maxsq
