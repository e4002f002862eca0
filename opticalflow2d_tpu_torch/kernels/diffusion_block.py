"""Temporal-blocked Horn-Schunck diffusion: k Jacobi iterations per pass over
device memory, with the reference Logger's per-iteration sums (CUDA
``csrc/diffusion_block.cu``, the counterpart of
``opticalflow2d_tpu/pallas_kernels/diffusion_block.py``): ``diffusion_block``
on the whole image, ``diffusion_block_strip`` on one strip of the
strip-parallel driver (``parallel.spatial``), pre-padded with its
neighbours' halo rows; ``diffusion_block_batch`` on the listed pairs of a
stack in one launch (the level loop, ``engine.registration``).

Relative error of iteration t is ``sums[t, 0] / sums[t, 1]``: the step
magnitude over the previous field's magnitude, both summed over the image
(the reference's mean per-pixel magnitudes, ``src/Motion.cpp:42-49`` via
``src/Logger.cpp:30-60``; the 1/N factors cancel).

A thread block holds one output tile with a halo of ``k`` cells in shared
memory, 7 planes (u twice, g) of the extended tile: the first of
``DIFFUSION_PLANS`` whose block fits (48 x 48, 115,712 B at k = 8, two
blocks an SM; else 32 x 32), the wrapper checking the card's limit before
the launch. The Logger partials have one row per tile (``diffusion_tiles``).
"""

from __future__ import annotations

from typing import Tuple

import torch

from opticalflow2d_tpu_torch import kernels
from opticalflow2d_tpu_torch.kernels import _build
from opticalflow2d_tpu_torch.kernels.demons_fused import MAX_SMEM_BYTES
from opticalflow2d_tpu_torch.kernels.diffusion_fused import diffusion_step_ref


# The kernel's plans (csrc/diffusion_stages.cuh kDiffusionPlans): output tile
# rows, columns and threads of a block, in order of preference; a launch
# takes the first whose shared memory fits a thread block at its k.
DIFFUSION_PLANS = ((48, 48, 512), (32, 32, 256))


def diffusion_smem_floats(k: int, tx: int, ty: int, threads: int) -> int:
    """Floats of shared memory of one block on plan ``(tx, ty, threads)``:
    u twice and g (7 planes) on the tile extended by ``k`` a side, and the
    per-iteration warp partials."""
    return 7 * (tx + 2 * k) * (ty + 2 * k) + k * (threads // 32) * 2


def diffusion_plan(k: int):
    """The plan a launch at ``k`` takes, or None where no block fits."""
    for p in DIFFUSION_PLANS:
        if 4 * diffusion_smem_floats(k, *p) <= MAX_SMEM_BYTES:
            return p
    return None


def diffusion_smem_bytes(k: int) -> int:
    """Shared memory of one block at ``k``, or, where no plan fits, of the
    last plan (more than a block has)."""
    return 4 * diffusion_smem_floats(k, *(diffusion_plan(k) or DIFFUSION_PLANS[-1]))


def diffusion_tiles(nx: int, ny: int, k: int) -> int:
    """Thread blocks, and rows of the Logger partials, of a launch over
    ``nx`` (a strip's ``nxl``) rows at ``k``."""
    tx, ty, _ = diffusion_plan(k)
    return -(-nx // tx) * -(-ny // ty)


def stack_derivs(grad_i: torch.Tensor, it: torch.Tensor) -> torch.Tensor:
    """Pack (gx, gy, It) into one ``[3, nx, ny]`` tensor, the kernel's force
    input (``[B, 3, nx, ny]`` from ``[B, 2, nx, ny]`` and ``[B, nx, ny]``
    over a leading pair axis). Loop-invariant: build it once per
    refinement."""
    return torch.cat([grad_i, it.unsqueeze(-3)], dim=-3)


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
    out = torch.empty_like(u)
    partials = torch.empty((lib.of2d_diffusion_block_nblocks(nx, ny, k), k, 2), dtype=u.dtype,
                           device=u.device)
    sums = torch.empty((k, 2), dtype=u.dtype, device=u.device)
    _build.launch(
        "of2d_diffusion_block", u.device, u.data_ptr(), g.data_ptr(),
        out.data_ptr(), partials.data_ptr(), sums.data_ptr(), nx, ny, k,
        _build.f32(alpha * alpha),
    )
    kernels.LAUNCHES["diffusion_block"] += 1
    return out, sums


def diffusion_block_batch_ref(u: torch.Tensor, g: torch.Tensor, alpha: float, k: int, pairs,
                              out: torch.Tensor | None = None):
    """Plain PyTorch version of the batched kernel: ``diffusion_block_ref``
    on each listed pair, into ``out[p]``; the sums ``[n_pairs, k, 2]`` in
    list order."""
    pairs = _build.as_pairs(pairs, u.shape[0])
    out = torch.zeros_like(u) if out is None else out
    sums = []
    for p in pairs:
        up, sp = diffusion_block_ref(u[p], g[p], alpha, k)
        out[p] = up
        sums.append(sp)
    return out, torch.stack(sums)


def diffusion_block_batch(u: torch.Tensor, g: torch.Tensor, alpha: float, k: int, pairs,
                          out: torch.Tensor | None = None):
    """``diffusion_block`` on the listed pairs of a stack in one launch:
    ``u [B, 2, nx, ny]``, ``g [B, 3, nx, ny]`` (``stack_derivs``),
    ``pairs`` distinct indices in ``[0, B)`` (or ``_build.Pairs``). Writes
    the ``k`` iterations of pair ``p`` into ``out[p]`` and leaves the other
    pairs of ``out`` as they are (zeros when ``out`` is None); returns
    ``(out, sums [n_pairs, k, 2])``, the sums in the order of ``pairs``.
    Each pair's field and sums equal its own ``diffusion_block`` call's.
    The plain version on the CPU, the kernel on CUDA."""
    if _build.on_cpu(u, g, *(() if out is None else (out,))):
        return diffusion_block_batch_ref(u, g, alpha, k, pairs, out)
    if u.device.type != "cuda":
        raise ValueError(f"no diffusion block for device {u.device}")
    if u.dim() != 4 or u.shape[1] != 2:
        raise ValueError(f"u must be [B, 2, nx, ny], got {tuple(u.shape)}")
    b, _, nx, ny = u.shape
    _build.check_cuda("u", u, (b, 2, nx, ny), u.device)
    _build.check_cuda("g", g, (b, 3, nx, ny), u.device)
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    pairs = _build.as_pairs(pairs, b)
    if out is None:
        out = torch.zeros_like(u)
    _build.check_out(out, u, u, g)
    lib = _build.load()
    _build.check_smem(lib.of2d_diffusion_block_smem_bytes(k), u.device,
                      f"a diffusion block with k={k} (use a smaller block_k)")
    n = len(pairs)
    partials = torch.empty((n, lib.of2d_diffusion_block_nblocks(nx, ny, k), k, 2),
                           dtype=u.dtype, device=u.device)
    sums = torch.empty((n, k, 2), dtype=u.dtype, device=u.device)
    # A stack of one takes no pair list: the kernel's single-pair path, which
    # skips the list's read at the start of each block (0.8% of B1's time at
    # 4096^2 on an H100).
    _build.launch(
        "of2d_diffusion_block_batch", u.device, u.data_ptr(), g.data_ptr(), out.data_ptr(),
        partials.data_ptr(), sums.data_ptr(), 0 if b == 1 else pairs.on(u.device).data_ptr(),
        n, nx, ny, k, _build.f32(alpha * alpha),
    )
    kernels.LAUNCHES["diffusion_block_batch"] += 1
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
    partials = torch.empty((lib.of2d_diffusion_block_nblocks(nxl, ny, k), k, 2),
                           dtype=u_pad.dtype, device=u_pad.device)
    sums = torch.empty((k, 2), dtype=u_pad.dtype, device=u_pad.device)
    _build.launch(
        "of2d_diffusion_block_strip", u_pad.device, u_pad.data_ptr(), g_pad.data_ptr(),
        out.data_ptr(), partials.data_ptr(), sums.data_ptr(), nxl, ny, k, pad, row0, nx_glob,
        _build.f32(alpha * alpha),
    )
    kernels.LAUNCHES["diffusion_block_strip"] += 1
    return out, sums
