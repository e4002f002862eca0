"""One Thirion demons iteration in one pass over device memory (CUDA
``csrc/demons_onepass.cu``, the counterpart of
``opticalflow2d_tpu/pallas_kernels/demons_onepass.py``):

    warp -> gradient -> force -> Gaussian(sigma_fluid)
         -> compose or add -> Gaussian(sigma_diffusion) -> u_new

with the reference Logger's sums ``[sum |u_new - u|, sum |u|]`` when asked
(reference ``src/regularization/Demons/DemonsThirions.cpp:18-42``). It also
carries diffeomorphic demons where the exp map is the identity
(``solvers.demons.expmap_identity_regime``).

A thread block holds its tile extended by ``2*(kernelwidth//2) + 1`` on
every side in shared memory; ``tile_fits`` says whether a kernelwidth
fits, and ``solvers.demons`` routes wider ones to the op chain before any
launch. The gathers are exact for any displacement: no halo bound, no
fallback.
"""

from __future__ import annotations

import torch

from opticalflow2d_tpu_torch import kernels
from opticalflow2d_tpu_torch.kernels import _build
from opticalflow2d_tpu_torch.kernels.demons_fused import (
    MAX_TAPS,
    TILE,
    WARPS,
    check_demons_inputs,
    demons_correspondence_ref,
    taps_array,
)
from opticalflow2d_tpu_torch.kernels.logger_norms import logger_norms_ref
from opticalflow2d_tpu_torch.kernels.warp_fused import compose_ref
from opticalflow2d_tpu_torch.ops.conv import convolve2d_clip

# Shared memory a thread block may use on the H100 (sm_90, opt-in), the
# limit ``tile_fits`` routes by; the wrappers check the card's own.
MAX_SMEM_BYTES = 232448


def onepass_smem_bytes(kernelwidth: int) -> int:
    """Shared memory of one B10 thread block (``demons_onepass.cu``)."""
    c = kernelwidth // 2
    e, m = TILE + 2 * (2 * c + 1), TILE + 4 * c
    return 4 * (2 * e * e + 2 * m * m + 2 * WARPS)


def tile_fits(kernelwidth: int) -> bool:
    """Whether the demons kernels take this kernelwidth: B10's tile, the
    widest of the three, fits an H100 thread block's shared memory."""
    return kernelwidth <= MAX_TAPS and onepass_smem_bytes(kernelwidth) <= MAX_SMEM_BYTES


def thirion_onepass_ref(iaux: torch.Tensor, iref: torch.Tensor, u: torch.Tensor,
                        sigma_i: float, sigma_x: float, sigma_fluid: float,
                        sigma_diffusion: float, kernelwidth: int,
                        addition: bool = False, with_errors: bool = False):
    """Plain PyTorch version of B10: ``u_new``, or ``(u_new, sums [2])``
    with ``with_errors``."""
    c = demons_correspondence_ref(iaux, iref, u, sigma_i, sigma_x, sigma_fluid, kernelwidth)
    new = u + c if addition else compose_ref(u, c)
    new = convolve2d_clip(new, sigma_diffusion, kernelwidth)
    return (new, logger_norms_ref(new, u)) if with_errors else new


def thirion_onepass(iaux: torch.Tensor, iref: torch.Tensor, u: torch.Tensor,
                    sigma_i: float, sigma_x: float, sigma_fluid: float,
                    sigma_diffusion: float, kernelwidth: int, addition: bool = False,
                    with_errors: bool = False):
    """One Thirion iteration of motion ``u [2, nx, ny]`` for the
    refinement-warped moving image ``iaux`` and the reference ``iref``
    (``[nx, ny]``): composition, or addition with ``addition``. Returns
    ``u_new``, or ``(u_new, sums)`` with ``with_errors``. The plain version
    on the CPU, B10 on CUDA."""
    if _build.on_cpu(iaux, iref, u):
        return thirion_onepass_ref(iaux, iref, u, sigma_i, sigma_x, sigma_fluid,
                                   sigma_diffusion, kernelwidth, addition, with_errors)
    nx, ny = check_demons_inputs(u, kernelwidth, onepass_smem_bytes(kernelwidth),
                                 images=(("iaux", iaux), ("iref", iref)))
    out = torch.empty_like(u)
    partials = sums = None
    if with_errors:
        nblocks = _build.load().of2d_demons_nblocks(nx, ny)
        partials = torch.empty((nblocks, 2), dtype=u.dtype, device=u.device)
        sums = torch.empty(2, dtype=u.dtype, device=u.device)
    _build.launch(
        "of2d_demons_onepass", u.device, iaux.data_ptr(), iref.data_ptr(), u.data_ptr(),
        out.data_ptr(), None if partials is None else partials.data_ptr(),
        None if sums is None else sums.data_ptr(), nx, ny, kernelwidth,
        taps_array(sigma_fluid, kernelwidth), taps_array(sigma_diffusion, kernelwidth),
        _build.f32(sigma_i * sigma_i), _build.f32(sigma_x * sigma_x), int(addition))
    kernels.LAUNCHES["demons_onepass"] += 1
    return (out, sums) if with_errors else out
