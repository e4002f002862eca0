"""The diffeomorphic demons iteration as two kernels, with the exp map
between them (CUDA ``csrc/demons_fused.cu``, the counterpart of
``opticalflow2d_tpu/pallas_kernels/demons_fused.py``):

- ``demons_correspondence`` (B11): ``gaussian_smooth(demons_force(
  derivatives(iref, warp2d(iaux, u))), sigma_fluid)``;
- ``compose_smooth`` (B12): ``gaussian_smooth(compose(u, c),
  sigma_diffusion)``.

Each thread block keeps its tile's intermediates in shared memory, so a
kernelwidth has to fit there (``demons_onepass.tile_fits``, the widest of
the three demons kernels); ``solvers.demons`` routes wider ones to the op
chain before any launch. The gathers are exact for any displacement: no
halo bound, no fallback.
"""

from __future__ import annotations

import ctypes

import torch

from opticalflow2d_tpu_torch import kernels
from opticalflow2d_tpu_torch.kernels import _build
from opticalflow2d_tpu_torch.kernels.warp_fused import compose_ref, warp2d_ref
from opticalflow2d_tpu_torch.ops.conv import convolve2d_clip, gaussian_taps
from opticalflow2d_tpu_torch.solvers.base import demons_force, derivatives

TILE = 32       # output tile of every demons kernel (csrc/demons_stages.cuh)
WARPS = 8       # warps per thread block
MAX_TAPS = 64   # the kernels' tap array (kMaxTaps)


def correspondence_smem_bytes(kernelwidth: int) -> int:
    """Shared memory of one B11 thread block (``demons_fused.cu``)."""
    c = kernelwidth // 2
    e, m = TILE + 2 * (c + 1), TILE + 2 * c
    return 4 * (2 * e * e + 2 * m * m)


def compose_smooth_smem_bytes(kernelwidth: int) -> int:
    """Shared memory of one B12 thread block (``demons_fused.cu``)."""
    d = TILE + 2 * (kernelwidth // 2)
    return 4 * 4 * d * d


def demons_correspondence_ref(iaux: torch.Tensor, iref: torch.Tensor, u: torch.Tensor,
                              sigma_i: float, sigma_x: float, sigma_fluid: float,
                              kernelwidth: int) -> torch.Tensor:
    """Plain PyTorch version of B11."""
    c = demons_force(derivatives(iref, warp2d_ref(iaux, u)), sigma_i, sigma_x)
    return convolve2d_clip(c, sigma_fluid, kernelwidth)


def compose_smooth_ref(u_total: torch.Tensor, c: torch.Tensor, sigma_diffusion: float,
                       kernelwidth: int) -> torch.Tensor:
    """Plain PyTorch version of B12."""
    return convolve2d_clip(compose_ref(u_total, c), sigma_diffusion, kernelwidth)


def taps_array(sigma: float, kernelwidth: int):
    """The float32 Gaussian taps as a ctypes array for a C entry point."""
    taps = gaussian_taps(sigma, kernelwidth)
    return (ctypes.c_float * len(taps))(*taps)


def check_demons_inputs(u: torch.Tensor, kernelwidth: int, smem_bytes: int,
                        images=(), fields=()):
    """The checks every demons wrapper makes on CUDA: device, dtype, shape
    and layout of ``u [2, nx, ny]``, of the ``(name, tensor)`` pairs in
    ``images`` (``[nx, ny]``) and ``fields`` (``[2, nx, ny]``), an odd
    kernelwidth, and a tile that fits the card's shared memory. Returns
    ``(nx, ny)``."""
    if u.device.type != "cuda":
        raise ValueError(f"no demons kernel for device {u.device}")
    if u.dim() != 3 or u.shape[0] != 2:
        raise ValueError(f"u must be [2, nx, ny], got {tuple(u.shape)}")
    _, nx, ny = u.shape
    _build.check_cuda("u", u, (2, nx, ny), u.device)
    for name, t in images:
        _build.check_cuda(name, t, (nx, ny), u.device)
    for name, t in fields:
        _build.check_cuda(name, t, (2, nx, ny), u.device)
    if kernelwidth < 1 or kernelwidth % 2 == 0 or kernelwidth > MAX_TAPS:
        raise ValueError(f"kernelwidth must be odd in [1, {MAX_TAPS}], got {kernelwidth}")
    _build.check_smem(smem_bytes, u.device, f"a demons tile with kernelwidth {kernelwidth}")
    return nx, ny


def demons_correspondence(iaux: torch.Tensor, iref: torch.Tensor, u: torch.Tensor,
                          sigma_i: float, sigma_x: float, sigma_fluid: float,
                          kernelwidth: int) -> torch.Tensor:
    """The smoothed demons correspondence ``[2, nx, ny]`` of motion ``u``
    for the refinement-warped moving image ``iaux`` and the reference
    ``iref`` (both ``[nx, ny]``); the plain version on the CPU, B11 on
    CUDA."""
    if _build.on_cpu(iaux, iref, u):
        return demons_correspondence_ref(iaux, iref, u, sigma_i, sigma_x, sigma_fluid,
                                         kernelwidth)
    nx, ny = check_demons_inputs(u, kernelwidth, correspondence_smem_bytes(kernelwidth),
                                 images=(("iaux", iaux), ("iref", iref)))
    out = torch.empty_like(u)
    _build.launch("of2d_demons_correspondence", u.device, iaux.data_ptr(), iref.data_ptr(),
                  u.data_ptr(), out.data_ptr(), nx, ny, kernelwidth,
                  taps_array(sigma_fluid, kernelwidth), _build.f32(sigma_i * sigma_i),
                  _build.f32(sigma_x * sigma_x))
    kernels.LAUNCHES["demons_correspondence"] += 1
    return out


def compose_smooth(u_total: torch.Tensor, c: torch.Tensor, sigma_diffusion: float,
                   kernelwidth: int) -> torch.Tensor:
    """``gaussian_smooth(compose(u_total, c), sigma_diffusion)`` of two
    ``[2, nx, ny]`` fields; the plain version on the CPU, B12 on CUDA."""
    if _build.on_cpu(u_total, c):
        return compose_smooth_ref(u_total, c, sigma_diffusion, kernelwidth)
    nx, ny = check_demons_inputs(u_total, kernelwidth,
                                 compose_smooth_smem_bytes(kernelwidth), fields=(("c", c),))
    out = torch.empty_like(u_total)
    _build.launch("of2d_compose_smooth", u_total.device, u_total.data_ptr(), c.data_ptr(),
                  out.data_ptr(), nx, ny, kernelwidth,
                  taps_array(sigma_diffusion, kernelwidth))
    kernels.LAUNCHES["compose_smooth"] += 1
    return out
