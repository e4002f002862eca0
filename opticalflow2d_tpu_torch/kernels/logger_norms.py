"""The reference Logger's norm pair ``[sum |u_new - u_prev|, sum |u_prev|]``
over per-pixel magnitudes (CUDA ``csrc/logger_norms.cu``, the counterpart
of ``opticalflow2d_tpu/pallas_kernels/logger_norms.py::logger_norms_pallas``),
and the fluid metrics: the pair and ``min(jacobian_det(u_new))`` in the
same pass (the counterpart of ``fluid_metrics_pallas``).

The relative error of a step is ``(sums[0] / N) / (sums[1] / N)``
(``src/Logger.cpp:30-60``). The kernel adds per-block partials in block
order, with no float atomics, so a run's stop repeats exactly; it takes any
grid, not only row counts that are multiples of 8. ``logger_norms_batch``
takes the listed pairs of two stacks in one launch (the level loop's
passes of one iteration).
"""

from __future__ import annotations

import torch

from opticalflow2d_tpu_torch import kernels
from opticalflow2d_tpu_torch.kernels import _build
from opticalflow2d_tpu_torch.ops.grid import jacobian_det


def logger_norms_ref(u_new: torch.Tensor, u_prev: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the ``[2]`` sums."""
    d = u_new - u_prev
    dsum = torch.sqrt(d[0] * d[0] + d[1] * d[1]).sum()
    psum = torch.sqrt(u_prev[0] * u_prev[0] + u_prev[1] * u_prev[1]).sum()
    return torch.stack([dsum, psum])


def _check_pair(u_new: torch.Tensor, u_prev: torch.Tensor, what: str):
    if u_prev.device.type != "cuda":
        raise ValueError(f"no {what} for device {u_prev.device}")
    if u_prev.dim() != 3 or u_prev.shape[0] != 2:
        raise ValueError(f"u_prev must be [2, nx, ny], got {tuple(u_prev.shape)}")
    _, nx, ny = u_prev.shape
    _build.check_cuda("u_prev", u_prev, (2, nx, ny), u_prev.device)
    _build.check_cuda("u_new", u_new, (2, nx, ny), u_prev.device)
    return nx, ny


def logger_norms(u_new: torch.Tensor, u_prev: torch.Tensor) -> torch.Tensor:
    """Logger sums of two ``[2, nx, ny]`` fields; the plain version on the
    CPU, the kernel on CUDA."""
    if _build.on_cpu(u_new, u_prev):
        return logger_norms_ref(u_new, u_prev)
    nx, ny = _check_pair(u_new, u_prev, "Logger norms")
    lib = _build.load()
    partials = torch.empty((lib.of2d_logger_norms_nblocks(nx, ny), 2), dtype=u_prev.dtype,
                           device=u_prev.device)
    sums = torch.empty(2, dtype=u_prev.dtype, device=u_prev.device)
    _build.launch("of2d_logger_norms", u_prev.device, u_new.data_ptr(), u_prev.data_ptr(),
                  partials.data_ptr(), sums.data_ptr(), nx, ny)
    kernels.LAUNCHES["logger_norms"] += 1
    return sums


def logger_norms_batch_ref(u_new: torch.Tensor, u_prev: torch.Tensor, pairs) -> torch.Tensor:
    """Plain PyTorch version of the batched kernel: ``logger_norms_ref`` of
    each listed pair, ``[n_pairs, 2]``."""
    pairs = _build.as_pairs(pairs, u_prev.shape[0])
    return torch.stack([logger_norms_ref(u_new[p], u_prev[p]) for p in pairs])


def logger_norms_batch(u_new: torch.Tensor, u_prev: torch.Tensor, pairs) -> torch.Tensor:
    """Logger sums of the listed pairs of two ``[B, 2, nx, ny]`` stacks in
    one launch: ``[n_pairs, 2]`` in the order of ``pairs`` (distinct
    indices in ``[0, B)``), each equal to its own ``logger_norms`` call's.
    The plain version on the CPU, the kernel on CUDA."""
    if _build.on_cpu(u_new, u_prev):
        return logger_norms_batch_ref(u_new, u_prev, pairs)
    if u_prev.device.type != "cuda":
        raise ValueError(f"no Logger norms for device {u_prev.device}")
    if u_prev.dim() != 4 or u_prev.shape[1] != 2:
        raise ValueError(f"u_prev must be [B, 2, nx, ny], got {tuple(u_prev.shape)}")
    b, _, nx, ny = u_prev.shape
    _build.check_cuda("u_prev", u_prev, (b, 2, nx, ny), u_prev.device)
    _build.check_cuda("u_new", u_new, (b, 2, nx, ny), u_prev.device)
    pairs = _build.as_pairs(pairs, b)
    n = len(pairs)
    partials = torch.empty((n, _build.load().of2d_logger_norms_nblocks(nx, ny), 2),
                           dtype=u_prev.dtype, device=u_prev.device)
    sums = torch.empty((n, 2), dtype=u_prev.dtype, device=u_prev.device)
    _build.launch("of2d_logger_norms_batch", u_prev.device, u_new.data_ptr(),
                  u_prev.data_ptr(), partials.data_ptr(), sums.data_ptr(),
                  pairs.on(u_prev.device).data_ptr(), n, nx, ny)
    kernels.LAUNCHES["logger_norms_batch"] += 1
    return sums


def fluid_metrics_ref(u_new: torch.Tensor, u_prev: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the fluid metrics kernel:
    ``[sum |u_new - u_prev|, sum |u_prev|, min(jacobian_det(u_new))]``."""
    return torch.cat([logger_norms_ref(u_new, u_prev), jacobian_det(u_new).amin()[None]])


def fluid_metrics(u_new: torch.Tensor, u_prev: torch.Tensor) -> torch.Tensor:
    """The fluid loop's ``[3]`` metrics of two ``[2, nx, ny]`` fields: the
    Logger sums and the minimum Jacobian determinant of ``u_new``, which the
    regrid test reads (``src/Image.cpp:189-218``). The plain version on the
    CPU, the kernel on CUDA."""
    if _build.on_cpu(u_new, u_prev):
        return fluid_metrics_ref(u_new, u_prev)
    nx, ny = _check_pair(u_new, u_prev, "fluid metrics")
    if min(nx, ny) < 2:
        raise ValueError(f"the fluid metrics need nx, ny >= 2, got {(nx, ny)}")
    nblocks = _build.load().of2d_logger_norms_nblocks(nx, ny)
    partials = torch.empty(3 * nblocks, dtype=u_prev.dtype, device=u_prev.device)
    out = torch.empty(3, dtype=u_prev.dtype, device=u_prev.device)
    _build.launch("of2d_fluid_metrics", u_prev.device, u_new.data_ptr(), u_prev.data_ptr(),
                  partials.data_ptr(), out.data_ptr(), nx, ny)
    kernels.LAUNCHES["fluid_metrics"] += 1
    return out
