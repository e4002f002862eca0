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
every side in shared memory: 64 x 64 with two staging buffers where that
fits, else 32 x 32 with two or one (``onepass_plan``); ``tile_fits`` says
whether a kernelwidth fits at all, and ``solvers.demons`` routes wider ones
to the op chain before any launch. The Logger partials have one row a tile
(``onepass_tiles``). The gathers are exact for any displacement: no halo
bound, no fallback.

``thirion_onepass_strip`` (K5) is the same iteration, by composition and
without the Logger sums, on one strip of the strip-parallel driver
(``parallel.spatial``): the inputs carry ``pad >= onepass_strip_pad(halo,
kernelwidth)`` halo rows a side, and the gathers take their taps there
under the strips' displacement contract.
"""

from __future__ import annotations

import torch

from opticalflow2d_tpu_torch import kernels
from opticalflow2d_tpu_torch.kernels import _build
from opticalflow2d_tpu_torch.kernels.demons_fused import (
    MAX_TAPS,
    check_demons_inputs,
    check_strip_inputs,
    compose_smooth_rows,
    correspondence_rows,
    demons_correspondence_ref,
    plan,
    plan_smem_bytes,
    regions,
    strip_pad_rows,
    taps_array,
    threads,
)
from opticalflow2d_tpu_torch.kernels.logger_norms import logger_norms_ref
from opticalflow2d_tpu_torch.kernels.warp_fused import compose_ref
from opticalflow2d_tpu_torch.ops.conv import convolve2d_clip


def onepass_smem_floats(kernelwidth: int, tx: int, ty: int, nbuf: int) -> int:
    """Floats of shared memory of one B10 thread block on plan ``(tx, ty,
    nbuf)`` (``demons_onepass.cu``)."""
    ex, ey, mx, my, dx, dy = regions(kernelwidth, tx, ty, 2 * (kernelwidth // 2) + 1)
    stage = 2 * ex * ey + mx * my
    red = 2 * (threads(tx, ty) // 32)
    if nbuf == 1:
        return stage + ex * ey + red
    return (2 * stage + max(ex * ey, 2 * dx * my, 2 * dx * dy)
            + max(2 * mx * my, 2 * dx * dy, 2 * tx * dy) + red)


def onepass_plan(kernelwidth: int):
    """B10's and K5's ``(tx, ty, nbuf)`` at this kernelwidth, or None."""
    return plan(kernelwidth, onepass_smem_floats)


def onepass_smem_bytes(kernelwidth: int) -> int:
    """Shared memory of one B10 thread block (``demons_onepass.cu``)."""
    return plan_smem_bytes(kernelwidth, onepass_smem_floats)


def onepass_tiles(nx: int, ny: int, kernelwidth: int) -> int:
    """B10's tiles on an ``nx x ny`` image (a strip: its ``nxl`` rows): the
    rows of its Logger partials (``of2d_demons_nblocks``)."""
    tx, ty, _ = onepass_plan(kernelwidth)
    return -(-nx // tx) * -(-ny // ty)


def tile_fits(kernelwidth: int) -> bool:
    """Whether the demons kernels take this kernelwidth: B10's tile, the
    widest of the three, fits an H100 thread block's shared memory."""
    return kernelwidth <= MAX_TAPS and onepass_plan(kernelwidth) is not None


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
        partials = torch.empty((onepass_tiles(nx, ny, kernelwidth), 2), dtype=u.dtype,
                               device=u.device)
        sums = torch.empty(2, dtype=u.dtype, device=u.device)
    _build.launch(
        "of2d_demons_onepass", u.device, iaux.data_ptr(), iref.data_ptr(), u.data_ptr(),
        out.data_ptr(), None if partials is None else partials.data_ptr(),
        None if sums is None else sums.data_ptr(), nx, ny, kernelwidth,
        taps_array(sigma_fluid, kernelwidth), taps_array(sigma_diffusion, kernelwidth),
        _build.f32(sigma_i * sigma_i), _build.f32(sigma_x * sigma_x), int(addition))
    kernels.LAUNCHES["demons_onepass"] += 1
    return (out, sums) if with_errors else out


def onepass_strip_pad(halo: int, kernelwidth: int) -> int:
    """Rows an output row of K5 reaches: two smooths, the gradient and the
    warp's taps (``demons_onepass.cu``). The TPU kernel rounds this up to 8
    (``required_pad``); the strips here carry the exact reach."""
    return 2 * (kernelwidth // 2) + halo + 2


def thirion_onepass_strip_ref(iaux_pad, iref_pad, u_pad, row0: int, nx_glob: int,
                              sigma_i: float, sigma_x: float, sigma_fluid: float,
                              sigma_diffusion: float, kernelwidth: int, halo: int,
                              pad: int | None = None) -> torch.Tensor:
    """Plain PyTorch version of K5: the strip correspondence on the rows
    the sigma_diffusion smooth reaches, then the strip compose and smooth."""
    need = onepass_strip_pad(halo, kernelwidth)
    pad = need if pad is None else pad
    nxl = strip_pad_rows(u_pad, pad, need, "the strip Thirion iteration")
    c = kernelwidth // 2
    cs = correspondence_rows(iaux_pad, iref_pad, u_pad, pad, -c, nxl + c, row0, nx_glob,
                             sigma_i, sigma_x, sigma_fluid, kernelwidth, halo)
    return compose_smooth_rows(u_pad, cs, pad, 0, nxl, row0, nx_glob, sigma_diffusion,
                               kernelwidth, halo)


def thirion_onepass_strip(iaux_pad: torch.Tensor, iref_pad: torch.Tensor, u_pad: torch.Tensor,
                          row0: int, nx_glob: int, sigma_i: float, sigma_x: float,
                          sigma_fluid: float, sigma_diffusion: float, kernelwidth: int,
                          halo: int, pad: int | None = None) -> torch.Tensor:
    """One Thirion iteration by composition on one strip: ``iaux_pad,
    iref_pad [nxl + 2 pad, ny]`` and ``u_pad [2, nxl + 2 pad, ny]`` carry
    ``pad`` halo rows a side (zeros beyond the image), ``row0`` is the
    global index of the strip's first row and ``nx_glob`` the image's rows;
    ``pad`` defaults to the reach and may not be less. Returns the strip's
    ``u_new [2, nxl, ny]``. The plain version on the CPU, K5 on CUDA."""
    need = onepass_strip_pad(halo, kernelwidth)
    pad = need if pad is None else pad
    if _build.on_cpu(iaux_pad, iref_pad, u_pad):
        return thirion_onepass_strip_ref(iaux_pad, iref_pad, u_pad, row0, nx_glob, sigma_i,
                                         sigma_x, sigma_fluid, sigma_diffusion, kernelwidth,
                                         halo, pad)
    nxl = strip_pad_rows(u_pad, pad, need, "the strip Thirion iteration")
    ny = check_strip_inputs(nxl, pad, row0, nx_glob, kernelwidth,
                            onepass_smem_bytes(kernelwidth),
                            images=(("iaux_pad", iaux_pad), ("iref_pad", iref_pad)),
                            fields=(("u_pad", u_pad),))
    out = torch.empty((2, nxl, ny), dtype=u_pad.dtype, device=u_pad.device)
    _build.launch("of2d_demons_onepass_strip", u_pad.device, iaux_pad.data_ptr(),
                  iref_pad.data_ptr(), u_pad.data_ptr(), out.data_ptr(), nxl, ny, pad, row0,
                  nx_glob, halo, kernelwidth, taps_array(sigma_fluid, kernelwidth),
                  taps_array(sigma_diffusion, kernelwidth), _build.f32(sigma_i * sigma_i),
                  _build.f32(sigma_x * sigma_x))
    kernels.LAUNCHES["demons_onepass_strip"] += 1
    return out
