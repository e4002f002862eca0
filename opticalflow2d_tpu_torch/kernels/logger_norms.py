"""The reference Logger's norm pair ``[sum |u_new - u_prev|, sum |u_prev|]``
over per-pixel magnitudes (CUDA ``csrc/logger_norms.cu``, the counterpart
of ``opticalflow2d_tpu/pallas_kernels/logger_norms.py::logger_norms_pallas``).

The relative error of a step is ``(sums[0] / N) / (sums[1] / N)``
(``src/Logger.cpp:30-60``). The kernel adds per-block partials in block
order, with no float atomics, so a run's stop repeats exactly; it takes any
grid, not only row counts that are multiples of 8.
"""

from __future__ import annotations

import torch

from opticalflow2d_tpu_torch import kernels
from opticalflow2d_tpu_torch.kernels import _build


def logger_norms_ref(u_new: torch.Tensor, u_prev: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the ``[2]`` sums."""
    d = u_new - u_prev
    dsum = torch.sqrt(d[0] * d[0] + d[1] * d[1]).sum()
    psum = torch.sqrt(u_prev[0] * u_prev[0] + u_prev[1] * u_prev[1]).sum()
    return torch.stack([dsum, psum])


def logger_norms(u_new: torch.Tensor, u_prev: torch.Tensor) -> torch.Tensor:
    """Logger sums of two ``[2, nx, ny]`` fields; the plain version on the
    CPU, the kernel on CUDA."""
    if _build.on_cpu(u_new, u_prev):
        return logger_norms_ref(u_new, u_prev)
    if u_prev.device.type != "cuda":
        raise ValueError(f"no Logger norms for device {u_prev.device}")
    if u_prev.dim() != 3 or u_prev.shape[0] != 2:
        raise ValueError(f"u_prev must be [2, nx, ny], got {tuple(u_prev.shape)}")
    _, nx, ny = u_prev.shape
    _build.check_cuda("u_prev", u_prev, (2, nx, ny), u_prev.device)
    _build.check_cuda("u_new", u_new, (2, nx, ny), u_prev.device)
    lib = _build.load()
    partials = torch.empty((lib.of2d_logger_norms_nblocks(nx, ny), 2), dtype=u_prev.dtype,
                           device=u_prev.device)
    sums = torch.empty(2, dtype=u_prev.dtype, device=u_prev.device)
    _build.launch("of2d_logger_norms", u_prev.device, u_new.data_ptr(), u_prev.data_ptr(),
                  partials.data_ptr(), sums.data_ptr(), nx, ny)
    kernels.LAUNCHES["logger_norms"] += 1
    return sums
