"""The registration loop (PyTorch port of ``opticalflow2d_tpu.engine.
registration``: every family, with the SOR and the spectral Navier-Lame
solvers).

Control flow mirrors the reference (``ImageRegistrationOpticalFlow.cpp:97-151``):

    for s = nscales .. 0:                  coarse -> fine
        seed the level's motion            (the reference's down/upsample quirk)
        for refine in range(nrefine):
            warp the moving image, derive
            iterate until niter, or until the relative step norm < tol
            after iteration 1              (host loop: k diffusion or
                                            elastic iterations a pass, or
                                            one curvature, spectral
                                            elastic, demons or fluid
                                            iteration; fluid: + the regrid
                                            test)
            compose u <- u o u_est
        upsample to full resolution

The convergence monitor is the reference ``Logger`` (``src/Logger.cpp:32-58``):
``err_t = |u_t - u_{t-1}| / |u_{t-1}|`` with ``|.|`` the mean per-pixel
magnitude, ``err = 0`` when the previous norm is zero.
"""

from __future__ import annotations

import threading
from typing import NamedTuple, Tuple

import numpy as np
import torch

from opticalflow2d_tpu_torch.config import Method, RegConfig
from opticalflow2d_tpu_torch.kernels._build import Pairs
from opticalflow2d_tpu_torch.kernels.derive import derive
from opticalflow2d_tpu_torch.kernels.diffusion_block import (
    diffusion_block,
    diffusion_block_batch,
    stack_derivs,
)
from opticalflow2d_tpu_torch.kernels.diffusion_fused import (
    diffusion_step_batch,
    diffusion_step_fused,
)
from opticalflow2d_tpu_torch.kernels.elastic_block import elastic_block
from opticalflow2d_tpu_torch.kernels.logger_norms import (
    fluid_metrics,
    logger_norms,
    logger_norms_batch,
)
from opticalflow2d_tpu_torch.kernels.warp_fused import compose_batch, warp2d_batch
from opticalflow2d_tpu_torch.ops.resample import (
    downsample_image,
    downsample_motion,
    pyramid_dims,
    upsample_motion,
)
from opticalflow2d_tpu_torch.ops.warp import compose, warp2d
from opticalflow2d_tpu_torch.solvers.base import Derivatives, derivatives, lssd_force
from opticalflow2d_tpu_torch.solvers.curvature import make_curvature_solve, make_curvature_step
from opticalflow2d_tpu_torch.solvers.demons import make_demons_step
from opticalflow2d_tpu_torch.solvers.elastic import elastic_step
from opticalflow2d_tpu_torch.solvers.fluid import make_fluid_step, make_fluid_two_pass_step
from opticalflow2d_tpu_torch.solvers.navier_lame import (
    make_dirichlet_navier_lame_solver,
    make_spectral_navier_lame_solver,
)
from opticalflow2d_tpu_torch.utils.health import check_level_field
from opticalflow2d_tpu_torch.utils.profiling import entry, span

# The JAX package's name and value (opticalflow2d_tpu/engine/registration.py:
# 58), where it fences the derivatives from the loop at 16384 lanes. Here it
# selects a route, not a memory barrier: a fluid level whose larger extent
# exceeds it runs the two-pass iteration (red-black), as JAX's host-stepped
# level loop does there, and OpticalFlow2d sends a grid past it to
# register_phased.
_DERIV_BARRIER_MIN_EXTENT = 8192


class LevelTrace(NamedTuple):
    """Convergence trace of one (level, refinement) solve, the functional
    equivalent of the reference's ``Logger`` error array. A batch result
    (``parallel.register_batch``) holds a leading pair axis on every field
    but ``scale``: ``errors [B, niter]``, the counts ``[B]`` int64 tensors."""

    scale: int
    errors: torch.Tensor  # [niter] float32 on the CPU, 0 past the stop
    iterations: int       # iterations executed
    regrids: int          # fluid regrid count (0 for other methods)
    fallbacks: int = 0    # always 0: the gather is exact for any motion


class RegistrationResult(NamedTuple):
    motion: torch.Tensor               # [2, nx, ny] ([B, 2, nx, ny] for a batch)
    traces: Tuple[LevelTrace, ...]     # coarse -> fine, refine-major
    # Final coarsest-level field (the reference's motion[nscales]), which a
    # repeated session register continues from under
    # CompatFlags.persistent_motion; None when the run skipped that level.
    coarse_motion: torch.Tensor | None = None


# Blocks ``_solve_level_blocked`` launched ahead of the host's stop decision,
# and those of them it dropped because the stop landed in the block before.
LOOKAHEAD = {"ahead": 0, "discarded": 0}


class _HostSums:
    """The host's copy of a block's Logger sums ``[k, 2]``. On CUDA a pinned
    buffer filled by an asynchronous copy with an event recorded after it,
    so that a read waits for that block and not for one queued behind it;
    the buffer and the event are made once per device and ``k`` in each
    thread (pinning host memory in the loop would stall it). On the CPU a
    plain copy."""

    _cache = threading.local()

    def __init__(self, k: int, like: torch.Tensor):
        self.event = self.stream = None
        if like.device.type != "cuda":
            self.buf = torch.empty((k, 2), dtype=like.dtype)
            return
        made = self._cache.__dict__.setdefault("made", {})
        key = (like.device, k, like.dtype)
        if key not in made:
            made[key] = (torch.empty((k, 2), dtype=like.dtype, pin_memory=True),
                         torch.cuda.Event())
        self.buf, self.event = made[key]
        self.stream = torch.cuda.current_stream(like.device)

    def enqueue(self, sums: torch.Tensor) -> None:
        self.buf.copy_(sums, non_blocking=self.event is not None)
        if self.event is not None:
            self.event.record(self.stream)

    def read(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        return self.buf.numpy()


def _solve_level_blocked(u, iref, imov, cfg: RegConfig, niter: int,
                         scale: int, k: int, block_fn, recompute_fn):
    """Variational level driver over a temporal-blocked kernel: ``k`` solver
    iterations a pass, with the Logger's stop kept exact. The kernel emits
    the per-iteration step and previous-field magnitude sums; the host reads
    them once a block, and when the stop (or the niter cap) lands inside a
    block it recomputes the taken steps from the block's start with
    ``recompute_fn``.

    The host runs one block behind the device: block n + 1 is launched on
    block n's output before block n's sums are read, unless block n reaches
    the niter cap, so the device computes it while the host decides. When
    the stop lands in block n, block n + 1 is dropped unread (``discard``)
    and block n's field is taken as without it; ``LOOKAHEAD`` counts both.

    ``block_fn(u, g) -> (u_after_k, sums [k, 2])``;
    ``recompute_fn(u, g, n) -> u`` gives the same field as the first ``n``
    of those iterations."""
    nb = -(-niter // k)
    tol = np.float32(cfg.convergence_tol)
    traces = []
    for refine in range(cfg.nrefine):
        with span("solve", scale=scale, refine=refine, nx=u.shape[-2], ny=u.shape[-1]):
            with span("derive"):
                g = derive(iref, warp2d(imov, u))
            u_est = torch.zeros_like(u)
            errs = np.zeros(nb * k, np.float32)
            host = _HostSums(k, u)
            it = 0
            queued = block_fn(u_est, g) if niter > 0 else None
            while queued is not None:
                u_blk, sums = queued
                host.enqueue(sums)
                queued = None
                if it + k < niter:
                    queued = block_fn(u_blk, g)
                    LOOKAHEAD["ahead"] += 1
                with span("read", site="block"):
                    s = host.read()  # the one host read per block
                    prev = s[:, 1]
                    errs_blk = np.where(prev == 0, np.float32(0),
                                        s[:, 0] / np.where(prev == 0, np.float32(1), prev))
                    its = it + np.arange(k)
                    conv_vec = (errs_blk < tol) & (its > 1) & (its < niter)
                    conv = bool(conv_vec.any())
                    n_take = int(np.argmax(conv_vec)) + 1 if conv else min(niter - it, k)
                if conv and queued is not None:
                    with span("discard"):
                        queued = None
                    LOOKAHEAD["discarded"] += 1
                if n_take < k:
                    with span("recompute"):
                        u_est = recompute_fn(u_est, g, n_take)
                else:
                    u_est = u_blk
                errs[it:it + n_take] = errs_blk[:n_take]
                if cfg.verbose_stream:
                    for t in range(n_take):
                        print(f"  [scale {scale}] iteration {it + t + 1}: "
                              f"relative error {float(errs_blk[t]):.6f}", flush=True)
                it += n_take
            with span("compose"):
                u = compose(u, u_est)
            check_level_field(scale, refine, u_est, u)
            traces.append(LevelTrace(scale, torch.from_numpy(errs[:niter].copy()), it, 0))
    return u, traces


def _solve_level_batch(u, irefs, imovs, cfg: RegConfig, niter: int, scale: int, k: int,
                       block_fn, recompute_fn):
    """``_solve_level_blocked`` over a stack of pairs in lockstep: ``u [B, 2,
    nx, ny]``, ``irefs`` and ``imovs [B, nx, ny]``. Each pair keeps its own
    Logger stop and iteration count, as the JAX package's vmapped
    ``while_loop`` does; once it stops, its field does not change. A block
    launches its kernels once for the pairs still active and reads all
    their sums ``[n_active, k, 2]`` in one host read; a pair whose stop
    lands inside the block recomputes its taken steps from the block's
    start; a pair that has stopped leaves the active list and is not
    launched again (where JAX's vmap executes both branches under a mask,
    with the same results).

    The increments ping-pong between two stacks, ``cur`` (the block's
    start) and ``nxt``; a stopping pair's field goes to ``final``.
    ``block_fn(cur, g, pairs, nxt) -> sums [n, k, 2]`` writes the ``k``
    iterations of each listed pair into ``nxt``;
    ``recompute_fn(cur, g, pairs, n, nxt, final)`` writes the first ``n``
    of them into ``final`` and may overwrite the listed pairs of ``nxt``."""
    b = u.shape[0]
    nb = -(-niter // k)
    tol = np.float32(cfg.convergence_tol)
    everyone = Pairs(range(b), b)
    traces = []
    for refine in range(cfg.nrefine):
        with span("solve", scale=scale, refine=refine, nx=u.shape[-2], ny=u.shape[-1]):
            with span("derive"):
                d = derivatives(irefs, warp2d_batch(imovs, u, everyone))
                g = stack_derivs(d.grad_i, d.it)
            cur, nxt, final = torch.zeros_like(u), torch.empty_like(u), torch.zeros_like(u)
            errs = np.zeros((b, nb * k), np.float32)
            its = np.zeros(b, np.int64)
            active = everyone if niter > 0 else None
            while active is not None:
                sums = block_fn(cur, g, active, nxt)
                with span("read", site="batch"):
                    s = sums.cpu().numpy()  # the one host read per block
                    still, stop_full, stop_inside = [], [], {}
                    for z, p in enumerate(active):
                        prev = s[z, :, 1]
                        errs_blk = np.where(prev == 0, np.float32(0),
                                            s[z, :, 0] / np.where(prev == 0, np.float32(1), prev))
                        it = int(its[p])
                        its_blk = it + np.arange(k)
                        conv_vec = (errs_blk < tol) & (its_blk > 1) & (its_blk < niter)
                        conv = bool(conv_vec.any())
                        n_take = int(np.argmax(conv_vec)) + 1 if conv else min(niter - it, k)
                        errs[p, it:it + n_take] = errs_blk[:n_take]
                        if cfg.verbose_stream:
                            for t in range(n_take):
                                print(f"  [pair {p}] [scale {scale}] iteration {it + t + 1}: "
                                      f"relative error {float(errs_blk[t]):.6f}", flush=True)
                        its[p] = it + n_take
                        if not conv and its[p] < niter:
                            still.append(p)
                        elif n_take < k:
                            stop_inside.setdefault(n_take, []).append(p)
                        else:
                            stop_full.append(p)
                for p in stop_full:
                    final[p] = nxt[p]
                if stop_inside:
                    with span("recompute"):
                        for n_take, ps in stop_inside.items():
                            recompute_fn(cur, g, Pairs(ps, b), n_take, nxt, final)
                cur, nxt = nxt, cur
                if len(still) != len(active):
                    active = Pairs(still, b) if still else None
            with span("compose"):
                u = compose_batch(u, final, everyone)
            check_level_field(scale, refine, final, u)
            traces.append(LevelTrace(scale, torch.from_numpy(errs[:, :niter].copy()),
                                     torch.from_numpy(its), torch.zeros(b, dtype=torch.int64),
                                     torch.zeros(b, dtype=torch.int64)))
    return u, traces


def _diffusion_steps(u, g, n: int, alpha: float):
    for _ in range(n):
        u = diffusion_step_fused(u, g[:2], g[2], alpha)
    return u


def _diffusion_steps_batch(cur, g, pairs, n: int, nxt, final, alpha: float):
    """``n`` steps of the listed pairs from ``cur`` into ``final``, one
    launch a step, ping-ponging between ``final`` and ``nxt`` so that the
    last lands in ``final``."""
    bufs = (final, nxt) if n % 2 else (nxt, final)
    src = cur
    for t in range(n):
        src = diffusion_step_batch(src, g, alpha, pairs, bufs[t % 2])


def _single_step_pass(step):
    """A block of one iteration for ``_solve_level_blocked``: ``step(u, d)``
    and its Logger sums ``[1, 2]`` (B4 on the card)."""
    def block(u, g):
        new = step(u, Derivatives(g[:2], g[2]))
        return new, logger_norms(new, u)[None]

    return block


def _single_step_pass_batch(step):
    """A batched block of one iteration for ``_solve_level_batch``:
    ``step(u [n, 2, nx, ny], g [n, 3, nx, ny])`` on the listed pairs'
    fields, and their Logger sums ``[n, 1, 2]`` in one launch (B4)."""
    def block(cur, g, pairs, nxt):
        ix = pairs.on(cur.device).long()
        nxt.index_copy_(0, ix, step(cur.index_select(0, ix), g.index_select(0, ix)))
        return logger_norms_batch(nxt, cur, pairs)[:, None]

    return block


def _per_pair(step):
    """A step over a leading pair axis from a single-pair ``step(u, d)``."""
    def batched(u, g):
        return torch.stack([step(u[i], Derivatives(g[i, :2], g[i, 2]))
                            for i in range(u.shape[0])])

    return batched


def _navier_lame_spectral(cfg: RegConfig, nx: int, ny: int):
    """The spectral Navier-Lame solve of elastic and fluid, or ``None`` for
    the SOR sweep: ``"spectral"`` the periodic rfft2 solve,
    ``"spectral_dirichlet"`` the DST-I solve of the reference's interior
    Dirichlet system (its SOR fixed point, with the stencil flag)."""
    if cfg.navier_lame_solver == "sor":
        return None
    if cfg.navier_lame_solver == "spectral":
        return make_spectral_navier_lame_solver(nx, ny, cfg.mu, cfg.lam, cfg.torch_dtype)
    if cfg.navier_lame_solver == "spectral_dirichlet":
        return make_dirichlet_navier_lame_solver(
            nx, ny, cfg.mu, cfg.lam, cfg.torch_dtype,
            reference_stencil=cfg.compat.elastic_stencil_reference)
    raise ValueError(f"unknown navier_lame_solver {cfg.navier_lame_solver!r}")


def _solve_level_variational(u, iref, imov, cfg: RegConfig, niter: int, scale: int):
    """Diffusion / curvature / elastic: derivatives once per refinement,
    update-only iterations (reference ImageRegistrationOpticalFlow.cpp:
    97-151). Diffusion and red-black elastic run a blocked kernel:
    diffusion with ``k = cfg.block_k``, elastic with ``k = min(4,
    cfg.block_k)``, the JAX package's elastic default; the kernels mask
    ragged tiles, so no level needs an unblocked fallback. A stop inside an
    elastic block reruns the elastic kernel for the taken iterations from
    the block's start. Curvature, the spectral elastic solves and the
    lexicographic sweep have no kernel of their own: they run one step a
    pass, its Logger sums on B4. The curvature step (its eigenvalue table)
    and the spectral solver are built once a level."""
    nx, ny = iref.shape
    if cfg.method == Method.CURVATURE:
        step = make_curvature_step(nx, ny, cfg.alpha, cfg.tau, cfg.torch_dtype,
                                   cfg.resolved_dct_impl)
        return _solve_level_blocked(
            u, iref, imov, cfg, niter, scale, 1, block_fn=_single_step_pass(step),
            recompute_fn=None,  # never called: a block of one is always taken
        )
    if cfg.method == Method.DIFFUSION:
        k = cfg.block_k
        return _solve_level_blocked(
            u, iref, imov, cfg, niter, scale, k,
            block_fn=lambda v, g: diffusion_block(v, g, cfg.alpha, k),
            recompute_fn=lambda v, g, n: _diffusion_steps(v, g, n, cfg.alpha),
        )
    solve = _navier_lame_spectral(cfg, nx, ny)
    if solve is not None or cfg.sor_ordering == "lexicographic":
        if solve is not None:
            def step(v, d):
                return solve(lssd_force(d, v))
        else:
            def step(v, d):
                return elastic_step(v, d, cfg.mu, cfg.lam, cfg.omega,
                                    cfg.compat.elastic_stencil_reference, "lexicographic")
        return _solve_level_blocked(
            u, iref, imov, cfg, niter, scale, 1, block_fn=_single_step_pass(step),
            recompute_fn=None,  # never called: a block of one is always taken
        )
    if cfg.sor_ordering != "redblack":
        raise ValueError(f"unknown SOR ordering {cfg.sor_ordering!r}")
    k = min(4, cfg.block_k)
    args = (cfg.mu, cfg.lam, cfg.omega, cfg.compat.elastic_stencil_reference)
    return _solve_level_blocked(
        u, iref, imov, cfg, niter, scale, k,
        block_fn=lambda v, g: elastic_block(v, g, *args, k),
        recompute_fn=lambda v, g, n: elastic_block(v, g, *args, n)[0],
    )


def _solve_level_variational_batch(u, irefs, imovs, cfg: RegConfig, niter: int, scale: int):
    """``_solve_level_variational`` over a stack of pairs in lockstep
    (``_solve_level_batch``). Diffusion: B1 over the active pairs, B2 over
    those that stop inside a block (one launch a step for each count of
    taken steps). Curvature: its force over the active pairs' stack, its
    spectral solve once per pair, B4 over them: one cuBLAS matmul over the
    stack takes another algorithm than a pair's own and, over 600
    iterations at 1024^2, ends up to 7.9e-5 px from ``register`` on an
    H100, where the solve per pair keeps every pair bit-equal. Red-black
    elastic: B6 once per active pair. The spectral elastic solves and the
    lexicographic sweep: their step once per active pair, B4 over them."""
    nx, ny = irefs.shape[-2:]
    if cfg.method == Method.DIFFUSION:
        k = cfg.block_k
        return _solve_level_batch(
            u, irefs, imovs, cfg, niter, scale, k,
            block_fn=lambda cur, g, pairs, nxt: diffusion_block_batch(
                cur, g, cfg.alpha, k, pairs, nxt)[1],
            recompute_fn=lambda cur, g, pairs, n, nxt, final: _diffusion_steps_batch(
                cur, g, pairs, n, nxt, final, cfg.alpha),
        )
    if cfg.method == Method.CURVATURE:
        solve = make_curvature_solve(nx, ny, cfg.alpha, cfg.tau, cfg.torch_dtype,
                                     cfg.resolved_dct_impl)

        def step(v, g):
            rhs = v - cfg.tau * lssd_force(Derivatives(g[:, :2], g[:, 2]), v)
            return torch.stack([solve(r) for r in rhs])

        return _solve_level_batch(
            u, irefs, imovs, cfg, niter, scale, 1, block_fn=_single_step_pass_batch(step),
            recompute_fn=None,  # never called: a block of one is always taken
        )
    solve = _navier_lame_spectral(cfg, nx, ny)
    if solve is not None or cfg.sor_ordering == "lexicographic":
        if solve is not None:
            def step(v, d):
                return solve(lssd_force(d, v))
        else:
            def step(v, d):
                return elastic_step(v, d, cfg.mu, cfg.lam, cfg.omega,
                                    cfg.compat.elastic_stencil_reference, "lexicographic")
        return _solve_level_batch(
            u, irefs, imovs, cfg, niter, scale, 1,
            block_fn=_single_step_pass_batch(_per_pair(step)),
            recompute_fn=None,  # never called: a block of one is always taken
        )
    if cfg.sor_ordering != "redblack":
        raise ValueError(f"unknown SOR ordering {cfg.sor_ordering!r}")
    k = min(4, cfg.block_k)
    args = (cfg.mu, cfg.lam, cfg.omega, cfg.compat.elastic_stencil_reference)

    def block(cur, g, pairs, nxt):
        return torch.stack([elastic_block(cur[p], g[p], *args, k, out=nxt[p])[1]
                            for p in pairs])

    def recompute(cur, g, pairs, n, nxt, final):
        for p in pairs:
            elastic_block(cur[p], g[p], *args, n, out=final[p])

    return _solve_level_batch(u, irefs, imovs, cfg, niter, scale, k, block, recompute)


def _solve_level_fluid(u, iref, imov, cfg: RegConfig, niter: int, scale: int):
    """Fluid: a velocity that starts at zero on each level and persists
    across its refinements, the adaptive timestep, and Jacobian-triggered
    regridding (reference ImageRegistrationFluid.cpp:67-142). Each
    iteration makes one host read, the ``[3]`` metrics ``[dsum, psum,
    jac_min]`` of the step; from it the host takes the Logger error, the
    stop and the regrid decision. The Logger's ``prev`` is the last logged
    estimate and survives a regrid (the reference's Logger lives outside
    the regrid block, ImageRegistrationFluid.cpp:99-124); a regrid runs
    only when the stop did not fire.

    A level whose larger extent exceeds ``_DERIV_BARRIER_MIN_EXTENT`` runs
    the red-black step in two passes that never store R (B8, then the gate,
    then B9), the JAX package's huge-grid iteration; it gives the same bits
    as the one-pass step (B7 and the plain Euler update). A spectral
    Navier-Lame solver takes neither: its velocity is the solve of the
    force, the rest of the step plain tensor ops."""
    kw = dict(dumax=cfg.dumax, timestep_skip=cfg.timestep_skip,
              maxabs_bug=cfg.compat.maxabs_bug,
              reference_stencil=cfg.compat.elastic_stencil_reference)
    solve = _navier_lame_spectral(cfg, u.shape[1], u.shape[2])
    if (solve is None and max(u.shape[1:]) > _DERIV_BARRIER_MIN_EXTENT
            and cfg.sor_ordering == "redblack"):
        step = make_fluid_two_pass_step(cfg.mu, cfg.lam, cfg.omega, **kw)
    else:
        step = make_fluid_step(cfg.mu, cfg.lam, cfg.omega, sor_ordering=cfg.sor_ordering,
                               spectral_solve=solve, **kw)
    n_pix = np.float32(u.shape[1] * u.shape[2])
    tol = np.float32(cfg.convergence_tol)
    threshold = np.float32(cfg.regrid_threshold)
    velocity = torch.zeros_like(u)
    traces = []
    for refine in range(cfg.nrefine):
        with span("solve", scale=scale, refine=refine, nx=u.shape[-2], ny=u.shape[-1]):
            with span("derive"):
                g = derive(iref, warp2d(imov, u))
            u_est = torch.zeros_like(u)
            prev = u_est
            errs = np.zeros(niter, np.float32)
            it, conv, nregrid = 0, False, 0
            while it < niter and not conv:
                u_new, velocity = step(u_est, velocity, g)
                with span("read", site="fluid"):
                    s = fluid_metrics(u_new, prev).cpu().numpy()  # the one host read
                    dn, pn = s[0] / n_pix, s[1] / n_pix
                    err = np.float32(0) if pn == 0 else dn / pn
                    conv = bool(err < tol) and it > 1
                errs[it] = err
                if cfg.verbose_stream:
                    print(f"  [scale {scale}] iteration {it + 1}: "
                          f"relative error {float(err):.6f}", flush=True)
                prev = u_new
                if not conv and s[2] < threshold:
                    with span("regrid", scale=scale, nx=u.shape[-2], ny=u.shape[-1]):
                        with span("compose"):
                            u = compose(u, u_new)
                        with span("derive"):
                            g = derive(iref, warp2d(imov, u))
                    u_new = torch.zeros_like(u_new)
                    nregrid += 1
                u_est = u_new
                it += 1
            with span("compose"):
                u = compose(u, u_est)
            check_level_field(scale, refine, u_est, u)
            traces.append(LevelTrace(scale, torch.from_numpy(errs), it, nregrid))
    return u, traces


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
    for refine in range(cfg.nrefine):
        with span("solve", scale=scale, refine=refine, nx=u.shape[-2], ny=u.shape[-1]):
            with span("derive"):
                iaux = warp2d(imov, u)
            u_est = torch.zeros_like(u)
            errs = np.zeros(niter, np.float32)
            it, conv = 0, False
            while it < niter and not conv:
                u_est, sums = step(u_est, iref, iaux)
                with span("read", site="demons"):
                    s = sums.cpu().numpy()  # the one host read per iteration
                    dn, pn = s[0] / n_pix, s[1] / n_pix
                    err = np.float32(0) if pn == 0 else dn / pn
                    conv = bool(err < tol) and it > 1
                errs[it] = err
                if cfg.verbose_stream:
                    print(f"  [scale {scale}] iteration {it + 1}: "
                          f"relative error {float(err):.6f}", flush=True)
                it += 1
            with span("compose"):
                u = compose(u, u_est)
            check_level_field(scale, refine, u_est, u)
            traces.append(LevelTrace(scale, torch.from_numpy(errs), it, 0))
    return u, traces


def _solve_level(u, iref, imov, cfg: RegConfig, niter: int, scale: int):
    if cfg.method == Method.FLUID:
        return _solve_level_fluid(u, iref, imov, cfg, niter, scale)
    if cfg.method in (Method.THIRIONS_DEMONS, Method.DIFFEOMORPHIC_DEMONS):
        return _solve_level_demons(u, iref, imov, cfg, niter, scale)
    return _solve_level_variational(u, iref, imov, cfg, niter, scale)


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
    with span("pyramid"):
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
                with span("seed"):
                    u_s = downsample_motion(u_full, dims[s])
            else:
                # The coarsest level starts from zero: the reference skips
                # the motion downsample at s == nscales.
                u_s = torch.zeros((2,) + dims[s], dtype=iref.dtype, device=iref.device)
        elif 0 < s < cfg.nscales:
            with span("seed"):
                u_s = downsample_motion(u_full, dims[s])
        else:  # s == 0
            u_s = u_full

        u_s, level_traces = _solve_level(u_s, irefs[s], imovs[s], cfg, int(cfg.niter[s]), s)
        traces.extend(level_traces)
        if s == cfg.nscales:
            coarse_final = u_s
        if s > 0:
            with span("upsample"):
                u_full = upsample_motion(u_s, dims[0])
        else:
            u_full = u_s

    return RegistrationResult(motion=u_full, traces=tuple(traces),
                              coarse_motion=coarse_final)


def _each(fn, stack: torch.Tensor, *args) -> torch.Tensor:
    """``fn`` on each pair of a stack, stacked: the pyramid's resampling runs
    per pair, with the 2D call ``register`` makes, since the downsample
    past 4096 adds in an order that follows the leading size
    (``ops.resample.box_product_accumulators``)."""
    return torch.stack([fn(x, *args) for x in stack])


def _register_batch_impl(irefs, imovs, cfg: RegConfig, initial_motions=None):
    """``_register_impl`` over a stack of pairs in lockstep, the counterpart
    of the JAX package's ``jax.vmap(_register_impl)``: ``irefs``, ``imovs
    [B, nx, ny]``, ``initial_motions [B, 2, nx, ny]`` or None. The levels
    and refinements advance together; within a refinement each pair stops
    on its own (``_solve_level_variational_batch``). Diffusion, curvature
    and elastic only. Every pair's result equals its own ``register``'s
    bit for bit: B1-B4 reduce each pair in the order of a single launch,
    and curvature's transforms run per pair."""
    if cfg.method not in (Method.DIFFUSION, Method.CURVATURE, Method.ELASTIC):
        raise NotImplementedError(
            f"the lockstep batch driver runs diffusion, curvature and elastic, not "
            f"{cfg.method.name}: its fluid and demons drivers are ROADMAP A15 part 2")
    b = irefs.shape[0]
    dims = pyramid_dims(tuple(irefs.shape[1:]), cfg.nscales)
    if min(dims[-1]) < 4:
        raise ValueError(
            f"nscales={cfg.nscales} shrinks the coarsest level to "
            f"{dims[-1]}; every level needs at least 4 pixels per side"
        )
    pyr_ref = {0: irefs}
    pyr_mov = {0: imovs}
    with span("pyramid"):
        for s in range(1, cfg.nscales + 1):
            pyr_ref[s] = _each(downsample_image, irefs, dims[s])
            pyr_mov[s] = _each(downsample_image, imovs, dims[s])
    if initial_motions is not None:
        u_full = initial_motions
    else:
        u_full = torch.zeros((b, 2) + dims[0], dtype=irefs.dtype, device=irefs.device)
    traces = []
    coarse_final = None
    for s in range(cfg.nscales, -1, -1):
        if s == cfg.nscales and s > 0 and initial_motions is None:
            u_s = torch.zeros((b, 2) + dims[s], dtype=irefs.dtype, device=irefs.device)
        elif s > 0:
            with span("seed"):
                u_s = _each(downsample_motion, u_full, dims[s])
        else:
            u_s = u_full
        u_s, level_traces = _solve_level_variational_batch(
            u_s, pyr_ref[s], pyr_mov[s], cfg, int(cfg.niter[s]), s)
        traces.extend(level_traces)
        if s == cfg.nscales:
            coarse_final = u_s
        if s > 0:
            with span("upsample"):
                u_full = _each(upsample_motion, u_s, dims[0])
        else:
            u_full = u_s
    return RegistrationResult(motion=u_full, traces=tuple(traces), coarse_motion=coarse_final)


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
    with entry("register"):
        return _register(iref, imov, cfg, initial_motion, start_scale, stop_scale,
                         initial_coarse_motion, device)


def _register(iref, imov, cfg, initial_motion, start_scale, stop_scale,
              initial_coarse_motion, device) -> RegistrationResult:
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
                                       "initial_coarse_motion (the coarsest level's field)",
                                       (2,) + coarse)
    if initial_motion is not None:
        initial_motion = _field(initial_motion, dtype, device, "initial_motion",
                                (2,) + tuple(iref.shape))
    return _register_impl(iref, imov, cfg, initial_motion, start_scale,
                          stop_scale, initial_coarse_motion)


def register_phased(iref, imov, cfg: RegConfig, initial_motion=None,
                    initial_coarse_motion=None, device=None) -> RegistrationResult:
    """The JAX API's huge-grid entry point, with ``register``'s result.

    In the JAX package it runs each pyramid phase as its own XLA program and
    the fluid levels past 8192 host-stepped, because one program per level
    does not compile or fit at 16384^2 on a TPU. The port's pyramid loop is
    already phased on the host, and its fluid levels past
    ``_DERIV_BARRIER_MIN_EXTENT`` take the two-pass iteration on their own,
    so this is ``register`` over the whole pyramid: the same validation and
    errors, the same warm starts (``initial_motion`` and
    ``initial_coarse_motion`` exclude each other), the same result.
    ``OpticalFlow2d`` calls it for a grid whose extent exceeds 8192."""
    return register(iref, imov, cfg, initial_motion=initial_motion,
                    initial_coarse_motion=initial_coarse_motion, device=device)
