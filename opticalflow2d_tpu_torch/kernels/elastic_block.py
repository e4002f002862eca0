"""Temporal-blocked elastic registration: k elastic iterations (the L-SSD
force, then a red and a black SOR half-sweep) per pass over device memory,
with the reference Logger's per-iteration sums (CUDA
``csrc/elastic_block.cu`` and ``csrc/elastic_stages.cuh``, the counterpart
of ``opticalflow2d_tpu/pallas_kernels/elastic_block.py``).

A thread block holds one output tile with a halo of ``2k`` cells in shared
memory, 7 planes (u twice, g) of the extended tile: the first of
``ELASTIC_PLANS`` whose block fits (48 x 48, 115.2 KB at k = 4, two blocks
an SM; else 32 x 32), the wrapper checking the card's limit before the
launch. The
Logger partials have one row per tile (``elastic_tiles``). Relative error
of iteration t is ``sums[t, 0] / sums[t, 1]``, as for the diffusion block.
``elastic_block_strip`` runs one strip of the strip-parallel driver
(``parallel.spatial``), pre-padded with its neighbours' halo rows; its
colours are those of the global rows.
"""

from __future__ import annotations

from typing import Tuple

import torch

from opticalflow2d_tpu_torch import kernels
from opticalflow2d_tpu_torch.kernels import _build
from opticalflow2d_tpu_torch.kernels.demons_fused import MAX_SMEM_BYTES
from opticalflow2d_tpu_torch.kernels.diffusion_block import _magnitude_sum
from opticalflow2d_tpu_torch.solvers.base import Derivatives
from opticalflow2d_tpu_torch.solvers.elastic import elastic_step, sor_scalars


# The kernel's plans (csrc/elastic_stages.cuh kElasticPlans): output tile
# rows, columns and threads of a block, in order of preference; a launch
# takes the first whose shared memory fits a thread block at its k.
ELASTIC_PLANS = ((48, 48, 512), (32, 32, 256))


def elastic_smem_floats(k: int, tx: int, ty: int, threads: int) -> int:
    """Floats of shared memory of one block on plan ``(tx, ty, threads)``:
    u twice and g (7 planes) on the tile extended by ``2k`` a side, and the
    per-iteration warp partials."""
    return 7 * (tx + 4 * k) * (ty + 4 * k) + k * (threads // 32) * 2


def elastic_plan(k: int):
    """The plan a launch at ``k`` takes, or None where no block fits."""
    for p in ELASTIC_PLANS:
        if 4 * elastic_smem_floats(k, *p) <= MAX_SMEM_BYTES:
            return p
    return None


def elastic_smem_bytes(k: int) -> int:
    """Shared memory of one block at ``k``, or, where no plan fits, of the
    last plan (more than a block has)."""
    return 4 * elastic_smem_floats(k, *(elastic_plan(k) or ELASTIC_PLANS[-1]))


def elastic_tiles(nx: int, ny: int, k: int) -> int:
    """Thread blocks, and rows of the Logger partials, of a launch over
    ``nx`` (a strip's ``nxl``) rows at ``k``."""
    tx, ty, _ = elastic_plan(k)
    return -(-nx // tx) * -(-ny // ty)


def elastic_block_ref(u: torch.Tensor, g: torch.Tensor, mu: float, lam: float, omega: float,
                      reference_stencil: bool, k: int, row0: int = 0,
                      nx_glob: int | None = None,
                      own: slice = slice(None)) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: ``k`` red-black elastic steps,
    and for each the sums ``[sum |u_t - u_{t-1}|, sum |u_{t-1}|]`` over the
    rows ``own`` as a ``[k, 2]`` tensor; ``row0``/``nx_glob`` as for
    ``solvers.elastic.sor_sweep``."""
    d = Derivatives(g[:2], g[2])
    sums = torch.empty((k, 2), dtype=u.dtype, device=u.device)
    for t in range(k):
        new = elastic_step(u, d, mu, lam, omega, reference_stencil, "redblack", row0, nx_glob)
        sums[t, 0] = _magnitude_sum(new[:, own] - u[:, own])
        sums[t, 1] = _magnitude_sum(u[:, own])
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
    out = torch.empty_like(u)
    partials = torch.empty((lib.of2d_elastic_nblocks(nx, ny, k), k, 2), dtype=u.dtype,
                           device=u.device)
    sums = torch.empty((k, 2), dtype=u.dtype, device=u.device)
    _build.launch(
        "of2d_elastic_block", u.device, u.data_ptr(), g.data_ptr(), out.data_ptr(),
        partials.data_ptr(), sums.data_ptr(), nx, ny, k,
        *sor_scalars(mu, lam, omega), int(reference_stencil),
    )
    kernels.LAUNCHES["elastic_block"] += 1
    return out, sums


def required_pad(k: int) -> int:
    """Halo rows a side that the strip-parallel driver gives a block of
    ``k`` elastic iterations, whose cone grows two rows an iteration:
    ``2k`` rounded up to 8, the TPU kernel's rows (``elastic_block.py:270``);
    the kernel needs ``pad >= 2k``."""
    return ((2 * k + 7) // 8) * 8


def elastic_block_strip_ref(u_pad: torch.Tensor, g_pad: torch.Tensor, row0: int,
                            nx_glob: int, mu: float, lam: float, omega: float,
                            reference_stencil: bool, k: int,
                            pad: int | None = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the strip kernel: ``elastic_block_ref`` on
    the padded strip with global colours and interior, the sums over the
    strip's own rows."""
    pad = required_pad(k) if pad is None else pad
    own = slice(pad, pad + _build.strip_rows(u_pad, pad))
    u, sums = elastic_block_ref(u_pad, g_pad, mu, lam, omega, reference_stencil, k,
                                row0 - pad, nx_glob, own)
    return u[:, own].contiguous(), sums


def elastic_block_strip(u_pad: torch.Tensor, g_pad: torch.Tensor, row0: int, nx_glob: int,
                        mu: float, lam: float, omega: float, reference_stencil: bool, k: int,
                        pad: int | None = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run ``k`` elastic iterations on one strip (arguments as for
    ``diffusion_block.diffusion_block_strip``; ``pad`` defaults to
    ``required_pad(k)`` and must be at least ``2k``). Returns ``(u_k [2,
    nxl, ny], sums [k, 2])``, the strip's own Logger sums. The plain version
    on the CPU, the kernel on CUDA."""
    pad = required_pad(k) if pad is None else pad
    if _build.on_cpu(u_pad, g_pad):
        return elastic_block_strip_ref(u_pad, g_pad, row0, nx_glob, mu, lam, omega,
                                       reference_stencil, k, pad)
    if u_pad.device.type != "cuda":
        raise ValueError(f"no elastic block for device {u_pad.device}")
    nxl, ny = _build.strip_rows(u_pad, pad), u_pad.shape[-1]
    _build.check_cuda("u_pad", u_pad, (2, nxl + 2 * pad, ny), u_pad.device)
    _build.check_cuda("g_pad", g_pad, (3, nxl + 2 * pad, ny), u_pad.device)
    _build.check_strip(row0, nxl, nx_glob)
    if not 1 <= 2 * k <= pad:
        raise ValueError(f"k must be in [1, pad / 2 = {pad // 2}], got {k}")
    lib = _build.load()
    _build.check_smem(lib.of2d_elastic_block_smem_bytes(k), u_pad.device,
                      f"an elastic block with k={k} (use a smaller block_k)")
    out = torch.empty((2, nxl, ny), dtype=u_pad.dtype, device=u_pad.device)
    partials = torch.empty((lib.of2d_elastic_nblocks(nxl, ny, k), k, 2), dtype=u_pad.dtype,
                           device=u_pad.device)
    sums = torch.empty((k, 2), dtype=u_pad.dtype, device=u_pad.device)
    _build.launch(
        "of2d_elastic_block_strip", u_pad.device, u_pad.data_ptr(), g_pad.data_ptr(),
        out.data_ptr(), partials.data_ptr(), sums.data_ptr(), nxl, ny, k, pad, row0, nx_glob,
        *sor_scalars(mu, lam, omega), int(reference_stencil),
    )
    kernels.LAUNCHES["elastic_block_strip"] += 1
    return out, sums
