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
chain before any launch. B11 takes a 64 x 64 tile where its shared memory
holds it with two staging buffers, else 32 x 32 (``correspondence_plan``);
B12 a 64 x 64 one with one staging buffer where it fits, else 32 x 32
(``compose_smooth_plan``). The gathers are exact for any displacement: no
halo bound, no fallback.

``demons_correspondence_strip`` (K6) and ``compose_smooth_strip`` (K7) are
the same on one strip of the strip-parallel driver (``parallel.spatial``):
the inputs carry ``pad`` halo rows a side, at least the reach of an output
row (``correspondence_strip_pad``, ``compose_smooth_strip_pad``), and the
gathers take their taps there under the strips' displacement contract.
"""

from __future__ import annotations

import ctypes

import torch

from opticalflow2d_tpu_torch import kernels
from opticalflow2d_tpu_torch.kernels import _build
from opticalflow2d_tpu_torch.kernels.warp_fused import (
    compose_ref, compose_strip_ref, warp2d_ref, warp2d_strip_ref)
from opticalflow2d_tpu_torch.ops.conv import convolve2d_clip, convolve2d_clip_rows, gaussian_taps
from opticalflow2d_tpu_torch.ops.grid import partial_x_rows, partial_y
from opticalflow2d_tpu_torch.solvers.base import Derivatives, demons_force, derivatives

# The kernels' tiles and staging (csrc/demons_stages.cuh): B10 and B11 take
# the first of PLANS (x rows, y columns, staging buffers) whose shared memory
# fits a thread block, B12 the first of COMPOSE_PLANS.
TILE = (64, 64)
SMALL_TILE = 32
PLANS = ((*TILE, 2), (SMALL_TILE, SMALL_TILE, 2), (SMALL_TILE, SMALL_TILE, 1))
COMPOSE_PLANS = ((*TILE, 1), (SMALL_TILE, SMALL_TILE, 1))
MAX_TAPS = 64   # the kernels' tap array (kMaxTaps)
# Shared memory a thread block may use on the H100 (sm_90, opt-in), the
# limit the plans are chosen by; the wrappers check the card's own.
MAX_SMEM_BYTES = 232448


def threads(tx: int, ty: int) -> int:
    """Threads of a block owning a ``tx x ty`` tile (``demons_threads``)."""
    return 512 if tx * ty >= 2048 else 256


def regions(kernelwidth: int, tx: int, ty: int, reach: int):
    """``(ex, ey, mx, my, dx, dy)``: the warp region (the tile extended by
    ``reach``), the force region (by ``reach - 1``) and B10's smoothed
    correspondence (by ``kernelwidth // 2``) of one tile (``DemonsGeo``)."""
    c = kernelwidth // 2
    return (tx + 2 * reach, ty + 2 * reach, tx + 2 * reach - 2, ty + 2 * reach - 2,
            tx + 2 * c, ty + 2 * c)


def correspondence_smem_floats(kernelwidth: int, tx: int, ty: int, nbuf: int) -> int:
    """Floats of shared memory of one B11 thread block on plan ``(tx, ty,
    nbuf)`` (``demons_fused.cu``)."""
    ex, ey, mx, my, _, _ = regions(kernelwidth, tx, ty, kernelwidth // 2 + 1)
    stage = 2 * ex * ey + mx * my
    if nbuf == 1:
        return stage + ex * ey
    return 2 * stage + max(ex * ey, 2 * tx * my) + 2 * mx * my


def plan(kernelwidth: int, smem_floats, plans=PLANS):
    """The first of ``plans`` whose ``smem_floats`` fits a thread block, or
    None (``demons_plan``)."""
    for p in plans:
        if 4 * smem_floats(kernelwidth, *p) <= MAX_SMEM_BYTES:
            return p
    return None


def plan_smem_bytes(kernelwidth: int, smem_floats, plans=PLANS) -> int:
    """Shared memory of a thread block on the kernelwidth's plan, or, where
    none fits, of the smallest layout (more than a block has)."""
    p = plan(kernelwidth, smem_floats, plans) or plans[-1]
    return 4 * smem_floats(kernelwidth, *p)


def correspondence_plan(kernelwidth: int):
    """B11's and K6's ``(tx, ty, nbuf)`` at this kernelwidth, or None."""
    return plan(kernelwidth, correspondence_smem_floats)


def correspondence_smem_bytes(kernelwidth: int) -> int:
    """Shared memory of one B11 thread block (``demons_fused.cu``)."""
    return plan_smem_bytes(kernelwidth, correspondence_smem_floats)


def compose_smooth_smem_floats(kernelwidth: int, tx: int, ty: int, nbuf: int) -> int:
    """Floats of shared memory of one B12 thread block on plan ``(tx, ty,
    nbuf)`` (``demons_fused.cu``): ``nbuf`` staging buffers of c's two planes
    on the tile extended by ``kernelwidth // 2``, the current one then
    holding the x pass, and the composed field on the same region."""
    *_, dx, dy = regions(kernelwidth, tx, ty, kernelwidth // 2)
    return (nbuf + 1) * 2 * dx * dy


def compose_smooth_plan(kernelwidth: int):
    """B12's and K7's ``(tx, ty, nbuf)`` at this kernelwidth, or None."""
    return plan(kernelwidth, compose_smooth_smem_floats, COMPOSE_PLANS)


def compose_smooth_smem_bytes(kernelwidth: int) -> int:
    """Shared memory of one B12 thread block (``demons_fused.cu``)."""
    return plan_smem_bytes(kernelwidth, compose_smooth_smem_floats, COMPOSE_PLANS)


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


# --- one strip of the strip-parallel driver (K6, K7) ---------------------------

def correspondence_strip_pad(halo: int, kernelwidth: int) -> int:
    """Rows an output row of K6 reaches: the sigma_fluid smooth, the
    gradient and the warp's taps (``demons_fused.cu``)."""
    return kernelwidth // 2 + halo + 2


def compose_smooth_strip_pad(halo: int, kernelwidth: int) -> int:
    """Rows an output row of K7 reaches: the sigma_diffusion smooth and the
    compose's taps."""
    return kernelwidth // 2 + halo + 1


def strip_pad_rows(t_pad: torch.Tensor, pad: int, need: int, what: str) -> int:
    """The rows a strip padded with ``pad`` rows a side owns; raise unless
    ``pad`` covers the kernel's reach ``need``."""
    if pad < need:
        raise ValueError(f"{what} needs a pad of at least {need} rows a side, got {pad}")
    return _build.strip_rows(t_pad, pad)


def _rows(t_pad: torch.Tensor, pad: int, lo: int, hi: int) -> torch.Tensor:
    """Local rows ``lo .. hi`` of a strip padded with ``pad`` rows a side."""
    return t_pad[..., pad + lo:pad + hi, :]


def correspondence_rows(iaux_pad: torch.Tensor, iref_pad: torch.Tensor, u_pad: torch.Tensor,
                        pad: int, lo: int, hi: int, row0: int, nx_glob: int, sigma_i: float,
                        sigma_x: float, sigma_fluid: float, kernelwidth: int,
                        halo: int) -> torch.Tensor:
    """B11's plain version on local rows ``lo .. hi`` of a strip whose first
    row is global row ``row0``: the strip warp on the rows the gradient and
    the smooth reach, its taps from the padded strip within the contract,
    the gradient (one-sided at the image's border rows), the force and the
    sigma_fluid smooth renormalized by global rows."""
    c, h1 = kernelwidth // 2, halo + 1
    wlo, whi = lo - c - 1, hi + c + 1
    iwar = warp2d_strip_ref(_rows(iaux_pad, pad, wlo - h1, whi + h1),
                            _rows(u_pad, pad, wlo, whi), row0 + wlo, nx_glob, halo)
    gi = torch.arange(row0 + wlo + 1, row0 + whi - 1, device=iwar.device)[:, None]
    grad = torch.stack([partial_x_rows(iwar, gi, nx_glob), partial_y(iwar[1:-1])])
    it = iwar[1:-1] - _rows(iref_pad, pad, wlo + 1, whi - 1)
    force = demons_force(Derivatives(grad, it), sigma_i, sigma_x)
    return convolve2d_clip_rows(force, row0 + wlo + 1, nx_glob, sigma_fluid, kernelwidth)


def compose_smooth_rows(u_pad: torch.Tensor, c_rows: torch.Tensor, pad: int, lo: int, hi: int,
                        row0: int, nx_glob: int, sigma_diffusion: float, kernelwidth: int,
                        halo: int) -> torch.Tensor:
    """B12's plain version on local rows ``lo .. hi`` of a strip:
    ``c_rows`` holds the correspondence on rows ``lo - c .. hi + c``, which
    is composed with the padded motion within the contract and smoothed."""
    c, h1 = kernelwidth // 2, halo + 1
    comp = compose_strip_ref(_rows(u_pad, pad, lo - c - h1, hi + c + h1), c_rows, row0 + lo - c,
                             nx_glob, halo)
    return convolve2d_clip_rows(comp, row0 + lo - c, nx_glob, sigma_diffusion, kernelwidth)


def demons_correspondence_strip_ref(iaux_pad, iref_pad, u_pad, row0: int, nx_glob: int,
                                    sigma_i: float, sigma_x: float, sigma_fluid: float,
                                    kernelwidth: int, halo: int, pad: int | None = None):
    """Plain PyTorch version of K6."""
    need = correspondence_strip_pad(halo, kernelwidth)
    pad = need if pad is None else pad
    nxl = strip_pad_rows(u_pad, pad, need, "the strip correspondence")
    return correspondence_rows(iaux_pad, iref_pad, u_pad, pad, 0, nxl, row0, nx_glob, sigma_i,
                               sigma_x, sigma_fluid, kernelwidth, halo)


def compose_smooth_strip_ref(u_pad, c_pad, row0: int, nx_glob: int, sigma_diffusion: float,
                             kernelwidth: int, halo: int, pad: int | None = None):
    """Plain PyTorch version of K7."""
    need = compose_smooth_strip_pad(halo, kernelwidth)
    pad = need if pad is None else pad
    nxl = strip_pad_rows(u_pad, pad, need, "the strip compose and smooth")
    c = kernelwidth // 2
    return compose_smooth_rows(u_pad, _rows(c_pad, pad, -c, nxl + c), pad, 0, nxl, row0,
                               nx_glob, sigma_diffusion, kernelwidth, halo)


def check_strip_inputs(nxl: int, pad: int, row0: int, nx_glob: int, kernelwidth: int,
                       smem_bytes: int, images=(), fields=()) -> int:
    """The checks every demons strip wrapper makes on CUDA: device, dtype,
    shape and layout of the padded ``images`` (``[nxl + 2 pad, ny]``) and
    ``fields`` (``[2, nxl + 2 pad, ny]``), the strip inside the image, an
    odd kernelwidth and a tile that fits. Returns ``ny``."""
    dev = fields[0][1].device
    if dev.type != "cuda":
        raise ValueError(f"no demons strip kernel for device {dev}")
    ny = fields[0][1].shape[-1]
    for name, t in images:
        _build.check_cuda(name, t, (nxl + 2 * pad, ny), dev)
    for name, t in fields:
        _build.check_cuda(name, t, (2, nxl + 2 * pad, ny), dev)
    _build.check_strip(row0, nxl, nx_glob)
    if kernelwidth < 1 or kernelwidth % 2 == 0 or kernelwidth > MAX_TAPS:
        raise ValueError(f"kernelwidth must be odd in [1, {MAX_TAPS}], got {kernelwidth}")
    _build.check_smem(smem_bytes, dev, f"a demons tile with kernelwidth {kernelwidth}")
    return ny


def demons_correspondence_strip(iaux_pad: torch.Tensor, iref_pad: torch.Tensor,
                                u_pad: torch.Tensor, row0: int, nx_glob: int, sigma_i: float,
                                sigma_x: float, sigma_fluid: float, kernelwidth: int, halo: int,
                                pad: int | None = None) -> torch.Tensor:
    """The smoothed correspondence ``[2, nxl, ny]`` of one strip:
    ``iaux_pad, iref_pad [nxl + 2 pad, ny]`` and ``u_pad [2, nxl + 2 pad,
    ny]`` carry ``pad`` halo rows a side (zeros beyond the image), ``row0``
    is the global index of the strip's first row and ``nx_glob`` the
    image's rows; ``pad`` defaults to the reach and may not be less. The
    plain version on the CPU, K6 on CUDA."""
    need = correspondence_strip_pad(halo, kernelwidth)
    pad = need if pad is None else pad
    if _build.on_cpu(iaux_pad, iref_pad, u_pad):
        return demons_correspondence_strip_ref(iaux_pad, iref_pad, u_pad, row0, nx_glob,
                                               sigma_i, sigma_x, sigma_fluid, kernelwidth, halo,
                                               pad)
    nxl = strip_pad_rows(u_pad, pad, need, "the strip correspondence")
    ny = check_strip_inputs(nxl, pad, row0, nx_glob, kernelwidth,
                            correspondence_smem_bytes(kernelwidth),
                            images=(("iaux_pad", iaux_pad), ("iref_pad", iref_pad)),
                            fields=(("u_pad", u_pad),))
    out = torch.empty((2, nxl, ny), dtype=u_pad.dtype, device=u_pad.device)
    _build.launch("of2d_demons_correspondence_strip", u_pad.device, iaux_pad.data_ptr(),
                  iref_pad.data_ptr(), u_pad.data_ptr(), out.data_ptr(), nxl, ny, pad, row0,
                  nx_glob, halo, kernelwidth, taps_array(sigma_fluid, kernelwidth),
                  _build.f32(sigma_i * sigma_i), _build.f32(sigma_x * sigma_x))
    kernels.LAUNCHES["demons_correspondence_strip"] += 1
    return out


def compose_smooth_strip(u_pad: torch.Tensor, c_pad: torch.Tensor, row0: int, nx_glob: int,
                         sigma_diffusion: float, kernelwidth: int, halo: int,
                         pad: int | None = None) -> torch.Tensor:
    """``gaussian_smooth(compose(u, c), sigma_diffusion)`` of one strip:
    ``u_pad, c_pad [2, nxl + 2 pad, ny]`` padded as for
    ``demons_correspondence_strip``. The plain version on the CPU, K7 on
    CUDA."""
    need = compose_smooth_strip_pad(halo, kernelwidth)
    pad = need if pad is None else pad
    if _build.on_cpu(u_pad, c_pad):
        return compose_smooth_strip_ref(u_pad, c_pad, row0, nx_glob, sigma_diffusion,
                                        kernelwidth, halo, pad)
    nxl = strip_pad_rows(u_pad, pad, need, "the strip compose and smooth")
    ny = check_strip_inputs(nxl, pad, row0, nx_glob, kernelwidth,
                            compose_smooth_smem_bytes(kernelwidth),
                            fields=(("u_pad", u_pad), ("c_pad", c_pad)))
    out = torch.empty((2, nxl, ny), dtype=u_pad.dtype, device=u_pad.device)
    _build.launch("of2d_compose_smooth_strip", u_pad.device, u_pad.data_ptr(), c_pad.data_ptr(),
                  out.data_ptr(), nxl, ny, pad, row0, nx_glob, halo, kernelwidth,
                  taps_array(sigma_diffusion, kernelwidth))
    kernels.LAUNCHES["compose_smooth_strip"] += 1
    return out
