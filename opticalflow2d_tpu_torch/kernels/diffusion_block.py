"""Temporal-blocked Horn-Schunck diffusion: k Jacobi iterations per pass over
device memory, with the reference Logger's per-iteration sums (CUDA
``csrc/diffusion_block.cu``, the counterpart of
``opticalflow2d_tpu/pallas_kernels/diffusion_block.py``).

Relative error of iteration t is ``sums[t, 0] / sums[t, 1]``: the step
magnitude over the previous field's magnitude, both summed over the image
(the reference's mean per-pixel magnitudes, ``src/Motion.cpp:42-49`` via
``src/Logger.cpp:30-60``; the 1/N factors cancel).
"""

from __future__ import annotations

from typing import Tuple

import torch

from opticalflow2d_tpu_torch import kernels
from opticalflow2d_tpu_torch.kernels import _build
from opticalflow2d_tpu_torch.kernels.diffusion_fused import diffusion_step_ref


def stack_derivs(grad_i: torch.Tensor, it: torch.Tensor) -> torch.Tensor:
    """Pack (gx, gy, It) into one ``[3, nx, ny]`` tensor, the kernel's force
    input. Loop-invariant: build it once per refinement."""
    return torch.cat([grad_i, it[None]], dim=0)


def _magnitude_sum(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(v[0] * v[0] + v[1] * v[1]).sum()


def diffusion_block_ref(u: torch.Tensor, g: torch.Tensor, alpha: float,
                        k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: ``k`` plain steps, and for each
    the sums ``[sum |u_t - u_{t-1}|, sum |u_{t-1}|]`` as a ``[k, 2]`` tensor."""
    sums = torch.empty((k, 2), dtype=u.dtype, device=u.device)
    for t in range(k):
        new = diffusion_step_ref(u, g[:2], g[2], alpha)
        sums[t, 0] = _magnitude_sum(new - u)
        sums[t, 1] = _magnitude_sum(u)
        u = new
    return u, sums


def diffusion_block(u: torch.Tensor, g: torch.Tensor, alpha: float,
                    k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run ``k`` diffusion iterations of ``u [2, nx, ny]`` with
    ``g = stack_derivs(grad_i, it)``; returns ``(u_k, sums [k, 2])``. The
    plain version on the CPU, the kernel on CUDA."""
    if _build.on_cpu(u, g):
        return diffusion_block_ref(u, g, alpha, k)
    if u.device.type != "cuda":
        raise ValueError(f"no diffusion block for device {u.device}")
    _, nx, ny = u.shape
    _build.check_cuda("u", u, (2, nx, ny), u.device)
    _build.check_cuda("g", g, (3, nx, ny), u.device)
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    lib = _build.load()
    _build.check_smem(lib.of2d_diffusion_block_smem_bytes(k), u.device,
                      f"a diffusion block with k={k} (use a smaller block_k)")
    nblocks = lib.of2d_diffusion_block_nblocks(nx, ny)
    out = torch.empty_like(u)
    partials = torch.empty((nblocks, k, 2), dtype=u.dtype, device=u.device)
    sums = torch.empty((k, 2), dtype=u.dtype, device=u.device)
    _build.launch(
        "of2d_diffusion_block", u.device, u.data_ptr(), g.data_ptr(),
        out.data_ptr(), partials.data_ptr(), sums.data_ptr(), nx, ny, k,
        _build.f32(alpha * alpha),
    )
    kernels.LAUNCHES["diffusion_block"] += 1
    return out, sums
