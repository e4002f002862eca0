"""The registration loop (PyTorch port of the diffusion and demons paths
of ``opticalflow2d_tpu.engine.registration``).

Control flow mirrors the reference (``ImageRegistrationOpticalFlow.cpp:97-151``):

    for s = nscales .. 0:                  coarse -> fine
        seed the level's motion            (the reference's down/upsample quirk)
        for refine in range(nrefine):
            warp the moving image, derive
            iterate until niter, or until the relative step norm < tol
            after iteration 1              (host loop: k diffusion
                                            iterations a pass, or one
                                            demons iteration)
            compose u <- u o u_est
        upsample to full resolution

The convergence monitor is the reference ``Logger`` (``src/Logger.cpp:32-58``):
``err_t = |u_t - u_{t-1}| / |u_{t-1}|`` with ``|.|`` the mean per-pixel
magnitude, ``err = 0`` when the previous norm is zero.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from opticalflow2d_tpu_torch.config import Method, RegConfig
from opticalflow2d_tpu_torch.kernels.diffusion_block import diffusion_block, stack_derivs
from opticalflow2d_tpu_torch.kernels.diffusion_fused import diffusion_step_fused
from opticalflow2d_tpu_torch.ops.resample import (
    downsample_image,
    downsample_motion,
    pyramid_dims,
    upsample_motion,
)
from opticalflow2d_tpu_torch.ops.warp import compose, warp2d
from opticalflow2d_tpu_torch.solvers.base import derivatives
from opticalflow2d_tpu_torch.solvers.demons import make_demons_step


class LevelTrace(NamedTuple):
    """Convergence trace of one (level, refinement) solve, the functional
    equivalent of the reference's ``Logger`` error array."""

    scale: int
    errors: torch.Tensor  # [niter] float32 on the CPU, 0 past the stop
    iterations: int       # iterations executed
    regrids: int          # fluid regrid count (0 for other methods)
    fallbacks: int = 0    # always 0: the gather is exact for any motion


class RegistrationResult(NamedTuple):
    motion: torch.Tensor               # [2, nx, ny]
    traces: Tuple[LevelTrace, ...]     # coarse -> fine, refine-major
    # Final coarsest-level field (the reference's motion[nscales]), which a
    # repeated session register continues from under
    # CompatFlags.persistent_motion; None when the run skipped that level.
    coarse_motion: torch.Tensor | None = None


def _solve_level_blocked(u, iref, imov, cfg: RegConfig, niter: int,
                         scale: int, k: int, block_fn, step_fn):
    """Variational level driver over a temporal-blocked kernel: ``k`` solver
    iterations a pass, with the Logger's stop kept exact. The kernel emits
    the per-iteration step and previous-field magnitude sums; the host reads
    them once a block, and when the stop (or the niter cap) lands inside a
    block it recomputes the taken steps from the block's start with
    ``step_fn``.

    ``block_fn(u, g) -> (u_after_k, sums [k, 2])``;
    ``step_fn(u, grad_i, it) -> u`` is the matching single step."""
    nb = -(-niter // k)
    tol = np.float32(cfg.convergence_tol)
    traces = []
    for _refine in range(cfg.nrefine):
        d = derivatives(iref, warp2d(imov, u))
        g = stack_derivs(d.grad_i, d.it)
        grad_i, it_img = g[:2], g[2]
        u_est = torch.zeros_like(u)
        errs = np.zeros(nb * k, np.float32)
        it, conv = 0, False
        while it < niter and not conv:
            u_blk, sums = block_fn(u_est, g)
            s = sums.cpu().numpy()  # the one host read per block
            prev = s[:, 1]
            errs_blk = np.where(prev == 0, np.float32(0),
                                s[:, 0] / np.where(prev == 0, np.float32(1), prev))
            its = it + np.arange(k)
            conv_vec = (errs_blk < tol) & (its > 1) & (its < niter)
            conv = bool(conv_vec.any())
            n_take = int(np.argmax(conv_vec)) + 1 if conv else min(niter - it, k)
            if n_take < k:
                for _ in range(n_take):
                    u_est = step_fn(u_est, grad_i, it_img)
            else:
                u_est = u_blk
            errs[it:it + n_take] = errs_blk[:n_take]
            if cfg.verbose_stream:
                for t in range(n_take):
                    print(f"  [scale {scale}] iteration {it + t + 1}: "
                          f"relative error {float(errs_blk[t]):.6f}", flush=True)
            it += n_take
        u = compose(u, u_est)
        traces.append(LevelTrace(scale, torch.from_numpy(errs[:niter].copy()), it, 0))
    return u, traces


def _solve_level_variational(u, iref, imov, cfg: RegConfig, niter: int, scale: int):
    """Diffusion: derivatives once per refinement, update-only iterations
    (reference ImageRegistrationOpticalFlow.cpp:97-151). Every level runs the
    blocked kernel with ``k = cfg.block_k``; the kernel masks ragged tiles,
    so no level needs an unblocked fallback."""
    k = cfg.block_k
    return _solve_level_blocked(
        u, iref, imov, cfg, niter, scale, k,
        block_fn=lambda v, g: diffusion_block(v, g, cfg.alpha, k),
        step_fn=lambda v, grad_i, it: diffusion_step_fused(v, grad_i, it, cfg.alpha),
    )


def _solve_level_demons(u, iref, imov, cfg: RegConfig, niter: int, scale: int):
    """Thirion / diffeomorphic demons: the solver re-warps and re-derives
    every iteration (reference ImageRegistrationDemons.cpp:86-137). The
    Logger's "prev" is the step's input, so the relative error comes from
    the step's own sums, read on the host once an iteration."""
    step = make_demons_step(
        cfg.sigma_i, cfg.sigma_x, cfg.sigma_diffusion, cfg.sigma_fluid,
        cfg.kernelwidth,
        diffeomorphic=(cfg.method == Method.DIFFEOMORPHIC_DEMONS),
        accumulation=cfg.accumulation,
        conv_flatwrap=cfg.compat.conv_flatwrap,
        maxabs_bug=cfg.compat.maxabs_bug,
        with_errors=True,
    )
    n_pix = np.float32(u.shape[1] * u.shape[2])
    tol = np.float32(cfg.convergence_tol)
    traces = []
    for _refine in range(cfg.nrefine):
        iaux = warp2d(imov, u)
        u_est = torch.zeros_like(u)
        errs = np.zeros(niter, np.float32)
        it, conv = 0, False
        while it < niter and not conv:
            u_est, sums = step(u_est, iref, iaux)
            s = sums.cpu().numpy()  # the one host read per iteration
            dn, pn = s[0] / n_pix, s[1] / n_pix
            err = np.float32(0) if pn == 0 else dn / pn
            errs[it] = err
            if cfg.verbose_stream:
                print(f"  [scale {scale}] iteration {it + 1}: "
                      f"relative error {float(err):.6f}", flush=True)
            conv = bool(err < tol) and it > 1
            it += 1
        u = compose(u, u_est)
        traces.append(LevelTrace(scale, torch.from_numpy(errs), it, 0))
    return u, traces


_NOT_PORTED = {
    Method.CURVATURE: "item 12",
    Method.ELASTIC: "item 9",
    Method.FLUID: "item 10",
}


def _solve_level(u, iref, imov, cfg: RegConfig, niter: int, scale: int):
    if cfg.method == Method.DIFFUSION:
        return _solve_level_variational(u, iref, imov, cfg, niter, scale)
    if cfg.method in (Method.THIRIONS_DEMONS, Method.DIFFEOMORPHIC_DEMONS):
        return _solve_level_demons(u, iref, imov, cfg, niter, scale)
    raise NotImplementedError(
        f"{cfg.method.name} is not ported yet (ROADMAP queue A, "
        f"{_NOT_PORTED[cfg.method]})")


def _register_impl(iref, imov, cfg: RegConfig, initial_motion=None,
                   start_scale=None, stop_scale=0, initial_coarse_motion=None):
    dims = pyramid_dims(tuple(iref.shape), cfg.nscales)
    if min(dims[-1]) < 4:
        # The reference would index out of bounds here; fail loudly instead.
        raise ValueError(
            f"nscales={cfg.nscales} shrinks the coarsest level to "
            f"{dims[-1]}; every level needs at least 4 pixels per side"
        )

    # Each level is downsampled directly from full resolution, as the
    # reference does (ImageRegistration.cpp:103-121).
    irefs = {0: iref}
    imovs = {0: imov}
    for s in range(1, cfg.nscales + 1):
        irefs[s] = downsample_image(iref, dims[s])
        imovs[s] = downsample_image(imov, dims[s])

    if initial_motion is not None:
        # Warm start: the full-resolution field seeds the pyramid, the
        # coarsest level included (the reference would keep its stale
        # motion[nscales] there; this is the self-consistent choice).
        u_full = initial_motion
    elif initial_coarse_motion is not None and cfg.nscales == 0:
        # Single-scale repeated-register continuation: the coarsest level
        # is the full-resolution field (WrapperOpticalFlow2d.cpp:86-102).
        u_full = initial_coarse_motion
    else:
        u_full = torch.zeros((2,) + dims[0], dtype=iref.dtype, device=iref.device)
    if start_scale is None:
        start_scale = cfg.nscales
    traces = []
    coarse_final = None
    for s in range(start_scale, stop_scale - 1, -1):
        if s == cfg.nscales and s > 0:
            if initial_coarse_motion is not None:
                # Repeated-register continuation (CompatFlags.
                # persistent_motion): the reference never re-seeds
                # motion[nscales] (ImageRegistration.cpp:137-139).
                u_s = initial_coarse_motion
            elif initial_motion is not None:
                u_s = downsample_motion(u_full, dims[s])
            else:
                # The coarsest level starts from zero: the reference skips
                # the motion downsample at s == nscales.
                u_s = torch.zeros((2,) + dims[s], dtype=iref.dtype, device=iref.device)
        elif 0 < s < cfg.nscales:
            u_s = downsample_motion(u_full, dims[s])
        else:  # s == 0
            u_s = u_full

        u_s, level_traces = _solve_level(u_s, irefs[s], imovs[s], cfg, int(cfg.niter[s]), s)
        traces.extend(level_traces)
        if s == cfg.nscales:
            coarse_final = u_s
        u_full = upsample_motion(u_s, dims[0]) if s > 0 else u_s

    return RegistrationResult(motion=u_full, traces=tuple(traces),
                              coarse_motion=coarse_final)


def resolve_device(device=None) -> torch.device:
    """The device a run takes place on: ``None`` means CUDA, and raises on a
    host without it; ``device="cpu"`` asks for the CPU (plain versions of
    the kernels)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on the GPU unless asked otherwise; "
                'pass device="cpu" to run on the CPU')
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)


def _field(x, dtype, device, name: str, shape: tuple) -> torch.Tensor:
    t = torch.as_tensor(x, dtype=dtype, device=device)
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must be {list(shape)}, got {list(t.shape)}")
    return t


def register(iref, imov, cfg: RegConfig, initial_motion=None,
             start_scale=None, stop_scale=0,
             initial_coarse_motion=None, device=None) -> RegistrationResult:
    """Estimate the motion field u with T(x + u) ~= R(x).

    Args:
      iref: reference image ``[nx, ny]``, a tensor or an array.
      imov: moving image ``[nx, ny]``.
      cfg: registration configuration.
      initial_motion: optional ``[2, nx, ny]`` warm-start field; it seeds
        every pyramid level by downsampling.
      initial_coarse_motion: optional coarsest-level field, the reference's
        repeated-register continuation (only ``motion[nscales]`` persists,
        ImageRegistration.cpp:137-139). Excludes ``initial_motion``.
      start_scale / stop_scale: run only scales ``start_scale .. stop_scale``
        (inclusive, coarse -> fine). With ``start_scale < cfg.nscales`` pass
        the full-resolution motion of the finished coarser levels as
        ``initial_motion`` (checkpoint resume).
      device: where the run takes place; every input, array or tensor, is
        moved there. ``None`` means CUDA (and raises on a host without
        it); ``"cpu"`` runs the kernels' plain versions on the CPU.

    Returns:
      ``RegistrationResult(motion=[2, nx, ny], traces=..., coarse_motion=...)``.
    """
    dtype = cfg.torch_dtype
    device = resolve_device(device)
    iref = torch.as_tensor(iref, dtype=dtype, device=device)
    imov = torch.as_tensor(imov, dtype=dtype, device=device)
    if iref.shape != imov.shape or iref.dim() != 2:
        raise ValueError(
            f"iref/imov must be matching 2D images, got {tuple(iref.shape)} "
            f"vs {tuple(imov.shape)}"
        )
    if start_scale is not None and not 0 <= start_scale <= cfg.nscales:
        raise ValueError(f"start_scale {start_scale} outside 0..{cfg.nscales}")
    if not 0 <= stop_scale <= (cfg.nscales if start_scale is None else start_scale):
        raise ValueError(f"stop_scale {stop_scale} outside the pyramid range")
    if initial_coarse_motion is not None:
        if initial_motion is not None:
            raise ValueError(
                "initial_motion and initial_coarse_motion are mutually "
                "exclusive (full-res warm start vs reference repeated-"
                "register continuation)"
            )
        coarse = pyramid_dims(tuple(iref.shape), cfg.nscales)[cfg.nscales]
        initial_coarse_motion = _field(initial_coarse_motion, dtype, device,
                                       "initial_coarse_motion", (2,) + coarse)
    if initial_motion is not None:
        initial_motion = _field(initial_motion, dtype, device, "initial_motion",
                                (2,) + tuple(iref.shape))
    return _register_impl(iref, imov, cfg, initial_motion, start_scale,
                          stop_scale, initial_coarse_motion)
