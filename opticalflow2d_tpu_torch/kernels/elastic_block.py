"""Temporal-blocked elastic registration: k elastic iterations (the L-SSD
force, then a red and a black SOR half-sweep) per pass over device memory,
with the reference Logger's per-iteration sums (CUDA
``csrc/elastic_block.cu``, the counterpart of
``opticalflow2d_tpu/pallas_kernels/elastic_block.py``).

A thread block holds its 32x32 tile with a halo of ``2k`` cells in shared
memory, 7 planes of ``(32 + 4k)^2`` floats: 64.5 KB at k = 4; the wrapper
checks the card's limit before the launch. Relative error of iteration t
is ``sums[t, 0] / sums[t, 1]``, as for the diffusion block.
"""

from __future__ import annotations

from typing import Tuple

import torch

from opticalflow2d_tpu_torch import kernels
from opticalflow2d_tpu_torch.kernels import _build
from opticalflow2d_tpu_torch.kernels.diffusion_block import _magnitude_sum
from opticalflow2d_tpu_torch.solvers.base import Derivatives
from opticalflow2d_tpu_torch.solvers.elastic import elastic_step, sor_scalars


def elastic_block_ref(u: torch.Tensor, g: torch.Tensor, mu: float, lam: float, omega: float,
                      reference_stencil: bool, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: ``k`` red-black elastic steps,
    and for each the sums ``[sum |u_t - u_{t-1}|, sum |u_{t-1}|]`` as a
    ``[k, 2]`` tensor."""
    d = Derivatives(g[:2], g[2])
    sums = torch.empty((k, 2), dtype=u.dtype, device=u.device)
    for t in range(k):
        new = elastic_step(u, d, mu, lam, omega, reference_stencil, "redblack")
        sums[t, 0] = _magnitude_sum(new - u)
        sums[t, 1] = _magnitude_sum(u)
        u = new
    return u, sums


def elastic_block(u: torch.Tensor, g: torch.Tensor, mu: float, lam: float, omega: float,
                  reference_stencil: bool, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run ``k`` elastic iterations of ``u [2, nx, ny]`` with
    ``g = stack_derivs(grad_i, it)``; returns ``(u_k, sums [k, 2])``. The
    plain version on the CPU, the kernel on CUDA."""
    if _build.on_cpu(u, g):
        return elastic_block_ref(u, g, mu, lam, omega, reference_stencil, k)
    if u.device.type != "cuda":
        raise ValueError(f"no elastic block for device {u.device}")
    _, nx, ny = u.shape
    _build.check_cuda("u", u, (2, nx, ny), u.device)
    _build.check_cuda("g", g, (3, nx, ny), u.device)
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    lib = _build.load()
    _build.check_smem(lib.of2d_elastic_block_smem_bytes(k), u.device,
                      f"an elastic block with k={k} (use a smaller block_k)")
    nblocks = lib.of2d_sor_nblocks(nx, ny)
    out = torch.empty_like(u)
    partials = torch.empty((nblocks, k, 2), dtype=u.dtype, device=u.device)
    sums = torch.empty((k, 2), dtype=u.dtype, device=u.device)
    _build.launch(
        "of2d_elastic_block", u.device, u.data_ptr(), g.data_ptr(), out.data_ptr(),
        partials.data_ptr(), sums.data_ptr(), nx, ny, k,
        *sor_scalars(mu, lam, omega), int(reference_stencil),
    )
    kernels.LAUNCHES["elastic_block"] += 1
    return out, sums
