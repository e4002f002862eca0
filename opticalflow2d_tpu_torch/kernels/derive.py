"""A level's image derivatives in one pass (CUDA ``csrc/derive.cu``).

The variational and fluid level drivers (``engine/registration.py``) build
their force input ``g [3, nx, ny]`` once a refinement, and the fluid driver
again at each regrid: the gradient of the warped moving image by central
differences, one-sided at the borders, and the temporal difference
``warped - iref`` (reference ``src/regularization/IterativeSolver.cpp:22-56``,
``src/gradients.h:9-32``). No TPU kernel did this: the JAX package forms them
in jnp (``opticalflow2d_tpu/solvers/base.py``). The kernel replaces the plain
version's launches and full-size temporaries with one launch that reads the
two images once and writes only ``g``. ``derive_batch`` takes the listed
pairs of a stack in one launch (the lockstep fluid driver).
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


def derive_batch_ref(irefs: torch.Tensor, warped: torch.Tensor, pairs,
                     out: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch version of the batched kernel: ``derive_ref`` of
    ``(irefs[p], warped[z])`` for the ``z``-th listed pair ``p``, into
    ``out[p]``."""
    pairs = _build.as_pairs(pairs, irefs.shape[0])
    if out is None:
        out = torch.zeros((irefs.shape[0], 3) + tuple(irefs.shape[1:]), dtype=irefs.dtype,
                          device=irefs.device)
    for z, p in enumerate(pairs):
        out[p] = derive_ref(irefs[p], warped[z])
    return out


def derive_batch(irefs: torch.Tensor, warped: torch.Tensor, pairs,
                 out: torch.Tensor | None = None) -> torch.Tensor:
    """``derive`` of the listed pairs of a stack in one launch: ``irefs [B,
    nx, ny]``, ``warped [n_pairs, nx, ny]`` in the order of ``pairs``
    (distinct indices in ``[0, B)``, or ``_build.Pairs``). Writes pair
    ``p``'s ``g`` into ``out[p]`` (``[B, 3, nx, ny]``) and leaves the other
    pairs as they are (zeros when ``out`` is None); each equals its own
    ``derive`` call's. The plain version on the CPU, the kernel on CUDA."""
    if _build.on_cpu(irefs, warped, *(() if out is None else (out,))):
        return derive_batch_ref(irefs, warped, pairs, out)
    if warped.device.type != "cuda":
        raise ValueError(f"no derive for device {warped.device}")
    if irefs.dim() != 3 or min(irefs.shape[1:]) < 2:
        raise ValueError(f"irefs must be [B, nx, ny] with nx, ny >= 2, got "
                         f"{tuple(irefs.shape)}")
    b, nx, ny = irefs.shape
    pairs = _build.as_pairs(pairs, b)
    _build.check_cuda("irefs", irefs, (b, nx, ny), warped.device)
    _build.check_cuda("warped", warped, (len(pairs), nx, ny), warped.device)
    if out is None:
        out = torch.zeros((b, 3, nx, ny), dtype=warped.dtype, device=warped.device)
    _build.check_cuda("out", out, (b, 3, nx, ny), warped.device)
    if out.untyped_storage().data_ptr() in (irefs.untyped_storage().data_ptr(),
                                            warped.untyped_storage().data_ptr()):
        raise ValueError("out must not share memory with an input")
    _build.launch("of2d_derive_batch", warped.device, irefs.data_ptr(), warped.data_ptr(),
                  out.data_ptr(), pairs.on(warped.device).data_ptr(), len(pairs), nx, ny)
    kernels.LAUNCHES["derive_batch"] += 1
    return out
