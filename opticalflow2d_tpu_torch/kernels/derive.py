"""A level's image derivatives in one pass (CUDA ``csrc/derive.cu``).

The variational and fluid level drivers (``engine/registration.py``) build
their force input ``g [3, nx, ny]`` once a refinement, and the fluid driver
again at each regrid: the gradient of the warped moving image by central
differences, one-sided at the borders, and the temporal difference
``warped - iref`` (reference ``src/regularization/IterativeSolver.cpp:22-56``,
``src/gradients.h:9-32``). No TPU kernel did this: the JAX package forms them
in jnp (``opticalflow2d_tpu/solvers/base.py``). The kernel replaces the plain
version's launches and full-size temporaries with one launch that reads the
two images once and writes only ``g``.
"""

from __future__ import annotations

import torch

from opticalflow2d_tpu_torch import kernels
from opticalflow2d_tpu_torch.kernels import _build
from opticalflow2d_tpu_torch.kernels.diffusion_block import stack_derivs
from opticalflow2d_tpu_torch.solvers.base import derivatives


def derive_ref(iref: torch.Tensor, warped: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel."""
    d = derivatives(iref, warped)
    return stack_derivs(d.grad_i, d.it)


def derive(iref: torch.Tensor, warped: torch.Tensor) -> torch.Tensor:
    """``g [3, nx, ny]``: d/dx and d/dy of ``warped [nx, ny]`` and
    ``warped - iref``; the plain version on the CPU, the kernel on CUDA."""
    if _build.on_cpu(iref, warped):
        return derive_ref(iref, warped)
    if warped.device.type != "cuda":
        raise ValueError(f"no derive for device {warped.device}")
    if warped.dim() != 2 or min(warped.shape) < 2:
        raise ValueError(f"warped must be [nx, ny] with nx, ny >= 2, got {tuple(warped.shape)}")
    nx, ny = warped.shape
    iref, warped = iref.contiguous(), warped.contiguous()
    _build.check_cuda("warped", warped, (nx, ny), warped.device)
    _build.check_cuda("iref", iref, (nx, ny), warped.device)
    g = torch.empty((3, nx, ny), dtype=warped.dtype, device=warped.device)
    _build.launch("of2d_derive", warped.device, iref.data_ptr(), warped.data_ptr(),
                  g.data_ptr(), nx, ny)
    kernels.LAUNCHES["derive"] += 1
    return g
