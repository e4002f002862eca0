"""Temporal-blocked Horn-Schunck diffusion: k Jacobi iterations per pass over
device memory, with the reference Logger's per-iteration sums (CUDA
``csrc/diffusion_block.cu``, the counterpart of
``opticalflow2d_tpu/pallas_kernels/diffusion_block.py``): ``diffusion_block``
on the whole image, ``diffusion_block_strip`` on one strip of the
strip-parallel driver (``parallel.spatial``), pre-padded with its
neighbours' halo rows.

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


def required_pad(k: int) -> int:
    """Halo rows a side that the strip-parallel driver gives a block of
    ``k`` iterations: ``k`` rounded up to 8, the TPU kernel's rows
    (``diffusion_block.py:292``); the kernel needs ``pad >= k``."""
    return ((k + 7) // 8) * 8


def diffusion_block_strip_ref(u_pad: torch.Tensor, g_pad: torch.Tensor, row0: int,
                              nx_glob: int, alpha: float, k: int,
                              pad: int | None = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the strip kernel: ``k`` plain steps on the
    padded strip with the image's border rows masked by global index, and
    for each the strip's sums over its own rows."""
    pad = required_pad(k) if pad is None else pad
    own = slice(pad, pad + _build.strip_rows(u_pad, pad))
    sums = torch.empty((k, 2), dtype=u_pad.dtype, device=u_pad.device)
    u = u_pad
    for t in range(k):
        new = diffusion_step_ref(u, g_pad[:2], g_pad[2], alpha, row0 - pad, nx_glob)
        sums[t, 0] = _magnitude_sum(new[:, own] - u[:, own])
        sums[t, 1] = _magnitude_sum(u[:, own])
        u = new
    return u[:, own].contiguous(), sums


def diffusion_block_strip(u_pad: torch.Tensor, g_pad: torch.Tensor, row0: int, nx_glob: int,
                          alpha: float, k: int,
                          pad: int | None = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run ``k`` diffusion iterations on one strip: ``u_pad [2, nxl + 2 pad,
    ny]`` and ``g_pad [3, ...]`` carry ``pad`` halo rows a side (zeros
    beyond the image), ``row0`` is the global index of the strip's first
    row and ``nx_glob`` the image's rows. ``pad`` defaults to
    ``required_pad(k)``; a rerun of fewer iterations from the same padded
    inputs passes the pad they carry. Returns ``(u_k [2, nxl, ny],
    sums [k, 2])``, the strip's own Logger sums. The plain version on the
    CPU, the kernel on CUDA."""
    pad = required_pad(k) if pad is None else pad
    if _build.on_cpu(u_pad, g_pad):
        return diffusion_block_strip_ref(u_pad, g_pad, row0, nx_glob, alpha, k, pad)
    if u_pad.device.type != "cuda":
        raise ValueError(f"no diffusion block for device {u_pad.device}")
    nxl, ny = _build.strip_rows(u_pad, pad), u_pad.shape[-1]
    _build.check_cuda("u_pad", u_pad, (2, nxl + 2 * pad, ny), u_pad.device)
    _build.check_cuda("g_pad", g_pad, (3, nxl + 2 * pad, ny), u_pad.device)
    _build.check_strip(row0, nxl, nx_glob)
    if not 1 <= k <= pad:
        raise ValueError(f"k must be in [1, pad = {pad}], got {k}")
    lib = _build.load()
    _build.check_smem(lib.of2d_diffusion_block_smem_bytes(k), u_pad.device,
                      f"a diffusion block with k={k} (use a smaller block_k)")
    out = torch.empty((2, nxl, ny), dtype=u_pad.dtype, device=u_pad.device)
    partials = torch.empty((lib.of2d_diffusion_block_nblocks(nxl, ny), k, 2),
                           dtype=u_pad.dtype, device=u_pad.device)
    sums = torch.empty((k, 2), dtype=u_pad.dtype, device=u_pad.device)
    _build.launch(
        "of2d_diffusion_block_strip", u_pad.device, u_pad.data_ptr(), g_pad.data_ptr(),
        out.data_ptr(), partials.data_ptr(), sums.data_ptr(), nxl, ny, k, pad, row0, nx_glob,
        _build.f32(alpha * alpha),
    )
    kernels.LAUNCHES["diffusion_block_strip"] += 1
    return out, sums
