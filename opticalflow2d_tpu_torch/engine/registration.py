"""The registration loop (PyTorch port of ``opticalflow2d_tpu.engine.
registration``: every family, with the SOR and the spectral Navier-Lame
solvers).

Control flow mirrors the reference (``ImageRegistrationOpticalFlow.cpp:97-151``):

    for s = nscales .. 0:                  coarse -> fine
        seed the level's motion            (the reference's down/upsample quirk)
        for refine in range(nrefine):
            warp the moving image, derive
            iterate until niter, or until the relative step norm falls
            below tol after iteration 1    (host loop: k diffusion or
                                            elastic iterations a pass, or
                                            one curvature, spectral
                                            elastic, demons or fluid
                                            iteration; fluid: + the regrid
                                            test)
            compose u <- u o u_est
        upsample to full resolution

The convergence monitor is the reference ``Logger`` (``src/Logger.cpp:32-58``):
``err_t = |u_t - u_{t-1}| / |u_{t-1}|`` with ``|.|`` the mean per-pixel
magnitude, ``err = 0`` when the previous norm is zero (``engine.logger``).
"""

from __future__ import annotations

import functools
import threading
from typing import NamedTuple, Tuple

import numpy as np
import torch

from opticalflow2d_tpu_torch.config import Method, RegConfig
from opticalflow2d_tpu_torch.engine.logger import block_stop, iteration_stops, relative_errors
from opticalflow2d_tpu_torch.kernels._build import Pairs
from opticalflow2d_tpu_torch.kernels.derive import derive, derive_batch
# diffusion_block stays importable here: the benchmark's tests patch it.
from opticalflow2d_tpu_torch.kernels.diffusion_block import (  # noqa: F401
    diffusion_block,
    diffusion_block_batch,
)
from opticalflow2d_tpu_torch.kernels.diffusion_fused import diffusion_step_batch
from opticalflow2d_tpu_torch.kernels.elastic_block import elastic_block
from opticalflow2d_tpu_torch.kernels.logger_norms import (
    fluid_metrics,
    fluid_metrics_batch,
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
from opticalflow2d_tpu_torch.solvers.base import Derivatives, lssd_force
from opticalflow2d_tpu_torch.solvers.curvature import make_curvature_step
from opticalflow2d_tpu_torch.solvers.demons import make_demons_step
from opticalflow2d_tpu_torch.solvers.elastic import elastic_step
from opticalflow2d_tpu_torch.solvers.fluid import (
    make_fluid_batch_step,
    make_fluid_step,
    make_fluid_two_pass_step,
)
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
    """The host's copy of a block's Logger sums ``[n, k, 2]``, in the first
    ``n`` rows of a ``[B, k, 2]`` buffer for a stack of ``B``. On CUDA a
    pinned buffer filled by an asynchronous copy with an event recorded
    after it, so that a read waits for that block and not for one queued
    behind it; the buffer and the event are made once per device, ``B`` and
    ``k`` in each thread (pinning host memory in the loop would stall it).
    On the CPU a plain copy."""

    _cache = threading.local()

    def __init__(self, b: int, k: int, like: torch.Tensor):
        self.event = self.stream = None
        if like.device.type != "cuda":
            self.buf = torch.empty((b, k, 2), dtype=like.dtype)
            return
        made = self._cache.__dict__.setdefault("made", {})
        key = (like.device, b, k, like.dtype)
        if key not in made:
            made[key] = (torch.empty((b, k, 2), dtype=like.dtype, pin_memory=True),
                         torch.cuda.Event())
        self.buf, self.event = made[key]
        self.stream = torch.cuda.current_stream(like.device)

    def enqueue(self, sums: torch.Tensor) -> None:
        buf = self.buf if len(sums) == len(self.buf) else self.buf[:len(sums)]
        buf.copy_(sums, non_blocking=self.event is not None)
        if self.event is not None:
            self.event.record(self.stream)

    def read(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        return self.buf.numpy()


@functools.lru_cache(maxsize=None)
def _everyone(b: int) -> Pairs:
    """Every pair of a stack of ``b``, made once, with its device copy."""
    return Pairs(range(b), b)


def _out(dst, like: torch.Tensor) -> torch.Tensor:
    return torch.empty_like(like) if dst is None else dst


def _stack(xs) -> torch.Tensor:
    """``torch.stack(xs)``, or a view of the one: a stack of one costs no copy."""
    return xs[0][None] if len(xs) == 1 else torch.stack(xs)


def _gather(single, batched, data, u):
    """B3 (warp or compose) on each pair of a stack in one launch, or the
    single launch for a stack of one (4-5% faster there, 4096^2 on an H100)."""
    if u.shape[0] == 1:
        return single(data[0], u[0])[None]
    return batched(data, u, _everyone(u.shape[0]), torch.empty_like(data))


def _solve_level_blocked(u, irefs, imovs, cfg: RegConfig, niter: int, scale: int, k: int,
                         block_fn, recompute_fn, batch: bool = False):
    """Variational level driver over a temporal-blocked kernel, on a stack
    of pairs ``u [B, 2, nx, ny]`` in lockstep (``register`` passes a stack
    of one): ``k`` iterations a launch for the pairs still active, and one
    host read a block of their Logger sums, from which each pair's stop is
    decided exactly (``engine.logger``), as the JAX package's vmapped
    ``while_loop`` decides it. A pair whose stop or niter cap lands inside
    a block recomputes its taken steps from the block's start; a stopped
    pair is not launched again.

    The host runs one block behind: block n + 1 is launched on block n's
    output before block n's sums are read, unless block n reaches the cap.
    A pair that stops in block n drops its share of block n + 1, and a
    block left with no pair is dropped unread (``discard``; ``LOOKAHEAD``
    counts). The increments rotate through three stacks (a block's start,
    its output, the block ahead); the kernels write only the listed pairs,
    so a stopped pair's field stays in its stack, and the stacks are
    gathered into one at the end, copying only where pairs stopped in
    different ones.

    ``block_fn(src, g, pairs, dst) -> (dst, sums [n, k, 2])`` writes the
    ``k`` iterations of the listed pairs into ``dst`` (a new stack where
    None); ``recompute_fn(src, g, pairs, n, final, other)`` writes the
    first ``n`` into ``final``, with ``other`` (or None) between. ``batch``
    tags each verbose line with its pair and each read ``site="batch"``."""
    b = u.shape[0]
    nb = -(-niter // k)
    tol = np.float32(cfg.convergence_tol)
    traces = []
    for refine in range(cfg.nrefine):
        with span("solve", scale=scale, refine=refine, nx=u.shape[-2], ny=u.shape[-1]):
            with span("derive"):
                warped = _gather(warp2d, warp2d_batch, imovs, u)
                g = _stack([derive(irefs[p], warped[p]) for p in range(b)])
                del warped
            errs = np.zeros((b, nb * k), np.float32)
            its = np.zeros(b, np.int64)
            host = _HostSums(b, k, u)
            bufs = [torch.zeros_like(u), None, None]
            start, out, ahead = 0, 1, 2  # the roles of the three stacks
            where = [start if niter == 0 else None] * b  # the stack of a stopped pair
            active = _everyone(b) if niter > 0 else None
            queued = None
            if active is not None:
                bufs[out], sums = block_fn(bufs[start], g, active, None)
                queued = (active, sums)
            while queued is not None:
                launched, sums = queued
                host.enqueue(sums)
                queued = None
                it = int(its[active.idx[0]])  # the active pairs' common count
                if it + k < niter:
                    bufs[ahead], sums = block_fn(bufs[out], g, active, bufs[ahead])
                    queued = (active, sums)
                    LOOKAHEAD["ahead"] += 1
                still, inside = [], {}
                with span("read", site="batch" if batch else "block"):
                    s = host.read()  # the one host read per block
                    for z, p in enumerate(launched):
                        if where[p] is not None:
                            continue  # stopped in the block before
                        e = relative_errors(s[z, :, 0], s[z, :, 1])
                        n_take, stopped = block_stop(e, it, niter, tol)
                        errs[p, it:it + n_take] = e[:n_take]
                        if cfg.verbose_stream:
                            tag = f"[pair {p}] " if batch else ""
                            for t in range(n_take):
                                print(f"  {tag}[scale {scale}] iteration {it + t + 1}: "
                                      f"relative error {float(e[t]):.6f}", flush=True)
                        its[p] = it + n_take
                        if not stopped and its[p] < niter:
                            still.append(p)
                            continue
                        where[p] = out
                        if n_take < k:
                            inside.setdefault(n_take, []).append(p)
                if queued is not None and not still:
                    with span("discard"):
                        queued = None
                    LOOKAHEAD["discarded"] += 1
                if inside:
                    with span("recompute"):
                        for n_take, ps in inside.items():
                            pairs = active if len(ps) == len(active) else Pairs(ps, b)
                            recompute_fn(bufs[start], g, pairs, n_take, bufs[out],
                                         bufs[ahead])
                start, out, ahead = out, ahead, start
                if ahead not in where:
                    bufs[ahead] = None
                if len(still) != len(active):
                    active = Pairs(still, b) if still else None
            keep = max(set(where), key=where.count)
            for p, w in enumerate(where):
                if w != keep:
                    bufs[keep][p] = bufs[w][p]
            inc, bufs = bufs[keep], None
            with span("compose"):
                u = _gather(compose, compose_batch, u, inc)
            check_level_field(scale, refine, inc, u)
            del inc  # not held through the next refinement
            traces.append(LevelTrace(scale, torch.from_numpy(errs[:, :niter].copy()),
                                     torch.from_numpy(its), torch.zeros(b, dtype=torch.int64),
                                     torch.zeros(b, dtype=torch.int64)))
    return u, traces


def _single_step_pass(step):
    """A block of one iteration: ``step(u [2, nx, ny], d)`` on each listed
    pair, and their Logger sums ``[n, 1, 2]`` in one launch (B4). The step
    runs per pair: a cuBLAS matmul over the stack takes another algorithm
    than a pair's own and rounds apart from it."""
    def block(src, g, pairs, dst):
        new = [step(src[p], Derivatives(g[p, :2], g[p, 2])) for p in pairs]
        if dst is None and len(pairs) == src.shape[0]:
            dst = _stack(new)
        else:
            dst = _out(dst, src)
            for p, v in zip(pairs, new):
                dst[p] = v
        return dst, logger_norms_batch(dst, src, pairs)[:, None]

    return block


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


def _solve_level_variational(u, irefs, imovs, cfg: RegConfig, niter: int, scale: int,
                             batch: bool = False):
    """Diffusion / curvature / elastic on a stack of pairs ``u [B, 2, nx,
    ny]`` (``_solve_level_blocked``): derivatives once per refinement,
    update-only iterations (reference ImageRegistrationOpticalFlow.cpp:
    97-151). Diffusion runs B1 over the active pairs at ``k =
    cfg.block_k``, and B2 a step over those that stop inside a block;
    red-black elastic B6 per pair at ``k = min(4, cfg.block_k)``, the JAX
    package's default, rerun for a stop inside a block. The kernels mask
    ragged tiles. Curvature, the spectral elastic solves and the
    lexicographic sweep run one step a pass per pair, their Logger sums on
    B4; the curvature step and the spectral solver are built once a
    level."""
    nx, ny = irefs.shape[-2:]
    if cfg.method == Method.DIFFUSION:
        k = cfg.block_k

        def block(src, g, pairs, dst):
            return diffusion_block_batch(src, g, cfg.alpha, k, pairs, _out(dst, src))

        def recompute(src, g, pairs, n, final, other):
            # B2 a step, ping-ponging with other so that the last lands in final.
            other = _out(other, final) if n > 1 else other
            for t in range(n):
                src = diffusion_step_batch(src, g, cfg.alpha, pairs,
                                           final if (n - t) % 2 else other)

        return _solve_level_blocked(u, irefs, imovs, cfg, niter, scale, k, block, recompute,
                                    batch)
    solve = None if cfg.method == Method.CURVATURE else _navier_lame_spectral(cfg, nx, ny)
    if cfg.method == Method.CURVATURE:
        step = make_curvature_step(nx, ny, cfg.alpha, cfg.tau, cfg.torch_dtype,
                                   cfg.resolved_dct_impl)
    elif solve is not None:
        def step(v, d):
            return solve(lssd_force(d, v))
    elif cfg.sor_ordering == "lexicographic":
        def step(v, d):
            return elastic_step(v, d, cfg.mu, cfg.lam, cfg.omega,
                                cfg.compat.elastic_stencil_reference, "lexicographic")
    elif cfg.sor_ordering != "redblack":
        raise ValueError(f"unknown SOR ordering {cfg.sor_ordering!r}")
    else:
        k = min(4, cfg.block_k)
        args = (cfg.mu, cfg.lam, cfg.omega, cfg.compat.elastic_stencil_reference)

        def block(src, g, pairs, dst):
            dst = _out(dst, src)
            return dst, _stack([elastic_block(src[p], g[p], *args, k, out=dst[p])[1]
                                for p in pairs])

        def recompute(src, g, pairs, n, final, other):
            for p in pairs:
                elastic_block(src[p], g[p], *args, n, out=final[p])

        return _solve_level_blocked(u, irefs, imovs, cfg, niter, scale, k, block, recompute,
                                    batch)
    return _solve_level_blocked(
        u, irefs, imovs, cfg, niter, scale, 1, block_fn=_single_step_pass(step),
        recompute_fn=None,  # never called: a block of one is always taken
        batch=batch)


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
                    [err] = relative_errors([s[0] / n_pix], [s[1] / n_pix])
                    _, conv = block_stop([err], it, niter, tol)
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


def _copy_rows(dst: torch.Tensor, src: torch.Tensor, idx: torch.Tensor,
               scratch: torch.Tensor) -> None:
    """``dst[p] = src[p]`` for each pair ``p`` of the device list ``idx``, as
    many pairs at a time as ``scratch`` holds (it carries them)."""
    for z in range(0, len(idx), scratch.shape[0]):
        i = idx[z:z + scratch.shape[0]]
        rows = torch.index_select(src, 0, i, out=scratch[:len(i)])
        dst.index_copy_(0, i, rows)


def _gather_stacks(stacks, where: np.ndarray, scratch: torch.Tensor) -> int:
    """The index of the stack of ``stacks`` that holds most pairs' fields
    (``where[p]`` the index of pair ``p``'s), the other pairs' copied into
    it through ``scratch``."""
    keep = int(np.bincount(where, minlength=len(stacks)).argmax())
    for w in range(len(stacks)):
        if w != keep and (where == w).any():
            idx = torch.from_numpy(np.flatnonzero(where == w)).to(stacks[keep].device)
            _copy_rows(stacks[keep], stacks[w], idx, scratch)
    return keep


def _fluid_chunk(b: int) -> int:
    """The most pairs of a stack of ``b`` that the lockstep fluid loop
    copies, composes, warps or derives at once outside its kernels' pair
    axes: a quarter of the stack. A regrid's chunk then holds at most three
    fields of this many pairs (estimate, motion, composed), less than the
    R of all ``b`` pairs at a level's first step, and the tail's gather has
    a buffer of its own: the loop's peak falls at that first step whatever
    the data, and does not follow how many pairs regrid or stop together."""
    return max(1, b // 4)


def _solve_level_fluid_batch(u, irefs, imovs, cfg: RegConfig, niter: int, scale: int):
    """``_solve_level_fluid`` on a stack of pairs ``u [B, 2, nx, ny]`` in
    lockstep, for the red-black SOR sweep at extents up to
    ``_DERIV_BARRIER_MIN_EXTENT`` (``lockstep_refusal``). Each iteration
    launches B7 once for the pairs still iterating (``make_fluid_batch_step``:
    their Euler tails on per-pair timesteps) and B5 once into ``[n, 3]``
    (``fluid_metrics_batch``), and makes one host read of it, from which
    each pair's Logger error, stop and regrid test are decided as
    ``_solve_level_fluid`` decides them for one pair. The pairs that
    regrid at an iteration are composed, warped and derived again together,
    ``_fluid_chunk`` at a time (B3, U2 by its pair axis). Each pair keeps
    its own velocity (zero at the level's start, kept across its
    refinements and regrids), its Logger ``prev`` (which survives a regrid)
    and its counts; a pair that stops leaves the launches. So every pair's
    motion, counts and errors equal its own ``register``'s bit for bit.

    The estimates and the velocities each ping-pong between two stacks; the
    kernels write only the listed pairs, so a stopped pair's fields stay in
    the stack last written, and are gathered at the end. A pair that
    regridded enters the next iteration at a zero estimate; its ``prev``,
    the estimate it composed, waits in ``held`` and is put back into the
    input stack once the step has read it, before B5 reads it as ``prev``.
    The level's motion ``u`` is the caller's and is not written: the solve
    works on a copy. The stacks, ``held`` and the chunk ``scratch`` are
    made whatever the data, so the loop's memory does not depend on it."""
    b, _, nx, ny = u.shape
    step = make_fluid_batch_step(cfg.mu, cfg.lam, cfg.omega, dumax=cfg.dumax,
                                 timestep_skip=cfg.timestep_skip,
                                 maxabs_bug=cfg.compat.maxabs_bug,
                                 reference_stencil=cfg.compat.elastic_stencil_reference)
    n_pix = np.float32(nx * ny)
    tol = np.float32(cfg.convergence_tol)
    threshold = np.float32(cfg.regrid_threshold)
    vel = [torch.zeros_like(u), torch.empty_like(u)]
    v_at = np.zeros(b, np.int64)  # the velocity stack of each pair
    scratch = torch.empty((_fluid_chunk(b), 2, nx, ny), dtype=u.dtype, device=u.device)
    u = u.clone()
    traces = []
    for refine in range(cfg.nrefine):
        with span("solve", scale=scale, refine=refine, nx=nx, ny=ny):
            with span("derive"):
                warped = _gather(warp2d, warp2d_batch, imovs, u)
                g = derive_batch(irefs, warped, _everyone(b),
                                 torch.empty((b, 3, nx, ny), dtype=u.dtype, device=u.device))
                del warped
            v = _gather_stacks(vel, v_at, scratch) if refine else 0
            v_at[:] = v
            est = [torch.zeros_like(u), torch.empty_like(u)]
            held = torch.empty_like(u)
            cur = 0  # the stack of the active pairs' estimates
            errs = np.zeros((b, niter), np.float32)
            regrids = np.zeros(b, np.int64)
            e_at = np.zeros(b, np.int64)  # the stack of a stopped pair's estimate
            its = np.zeros(b, np.int64)
            active = _everyone(b) if niter > 0 else None
            ids = np.arange(b)  # the active pairs
            it = 0  # their common count
            prev = None  # the device list of the pairs whose Logger prev is in held
            while active is not None:
                nxt = 1 - cur
                step(est[cur], vel[v], g, active, vel[1 - v], est[nxt], scratch)
                if prev is not None:
                    _copy_rows(est[cur], held, prev, scratch)
                    prev = None
                sums = fluid_metrics_batch(est[nxt], est[cur], active)
                with span("read", site="fluid_batch"):
                    s = sums.cpu().numpy()  # the one host read per iteration
                    err, conv = iteration_stops(s[:, 0] / n_pix, s[:, 1] / n_pix, it, niter,
                                                tol)
                    errs[ids, it] = err
                    its[ids] = it + 1
                    if cfg.verbose_stream:
                        for p, e in zip(ids, err):
                            print(f"  [pair {p}] [scale {scale}] iteration {it + 1}: "
                                  f"relative error {float(e):.6f}", flush=True)
                    again = ids[~conv & (s[:, 2] < threshold)]
                    going = ~conv & (it + 1 < niter)
                    e_at[ids[~going]], v_at[ids[~going]] = nxt, 1 - v
                    ids = ids[going]
                if len(again):
                    prev = _regrid_batch(u, g, est[nxt], held, again.tolist(), ids.tolist(),
                                         irefs, imovs, scale)
                    regrids[again] += 1
                cur, v, it = nxt, 1 - v, it + 1
                if len(ids) != len(active):
                    active = Pairs(ids.tolist(), b) if len(ids) else None
            inc = est[_gather_stacks(est, e_at, scratch)]
            est = held = None
            with span("compose"):
                u = _gather(compose, compose_batch, u, inc)
            check_level_field(scale, refine, inc, u)
            del inc  # not held through the next refinement
            traces.append(LevelTrace(scale, torch.from_numpy(errs), torch.from_numpy(its),
                                     torch.from_numpy(regrids),
                                     torch.zeros(b, dtype=torch.int64)))
    return u, traces


def _regrid_batch(u, g, new, held, again: list, still: list, irefs, imovs, scale: int):
    """The regrids of the pairs ``again`` at one iteration of
    ``_solve_level_fluid_batch``, ``_fluid_chunk`` at a time: each composes
    its estimate (in ``new``) into its motion in ``u`` (in place), its
    moving image is warped and derived again into ``g``, its estimate is
    kept in ``held`` (its Logger ``prev``) and zeroed in ``new``. Returns the
    device list of the pairs of ``again`` still iterating (``still``), whose
    ``prev`` is then in ``held``, or None."""
    b, _, nx, ny = u.shape
    with span("regrid", scale=scale, nx=nx, ny=ny, pairs=len(again)):
        pairs = Pairs(again, b)
        idx = pairs.on(u.device, torch.int64)
        pairs.on(u.device)
        c = _fluid_chunk(b)
        parts = [pairs.part(z, z + c) for z in range(0, len(again), c)]
        with span("compose"):
            for part in parts:
                i = part.on(u.device, torch.int64)
                inc = new.index_select(0, i)
                held.index_copy_(0, i, inc)
                u.index_copy_(0, i, _gather(compose, compose_batch, u.index_select(0, i), inc))
                del inc
        with span("derive"):
            for part in parts:
                i = part.on(u.device, torch.int64)
                warped = _gather(warp2d, warp2d_batch, imovs.index_select(0, i),
                                 u.index_select(0, i))
                derive_batch(irefs, warped, part, g)
                del warped
        new.index_fill_(0, idx, 0.0)
    going = set(still)
    keep = [p for p in again if p in going]
    if not keep:
        return None
    if len(keep) == len(again):
        return idx
    return Pairs(keep, b).on(u.device, torch.int64)


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
                    [err] = relative_errors([s[0] / n_pix], [s[1] / n_pix])
                    _, conv = block_stop([err], it, niter, tol)
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
    u, traces = _solve_level_variational(u[None], iref[None], imov[None], cfg, niter, scale)
    return u[0], [LevelTrace(t.scale, t.errors[0], int(t.iterations), 0) for t in traces]


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


# The families the lockstep batch driver runs.
_LOCKSTEP = (Method.DIFFUSION, Method.CURVATURE, Method.ELASTIC, Method.FLUID)


def lockstep_refusal(cfg: RegConfig, dims=None) -> str | None:
    """Why the lockstep batch driver does not run ``cfg`` on images of
    ``dims`` (``None``: any size), or None where it does. It runs
    diffusion, curvature, elastic and fluid; fluid with the red-black SOR
    sweep (B7's pair axis) and only where no level's larger extent exceeds
    ``_DERIV_BARRIER_MIN_EXTENT``: past it a level takes the two-pass
    step (B8 + B9), which has no pair axis. Demons have no lockstep
    driver (ROADMAP A15 part 2)."""
    if cfg.method not in _LOCKSTEP:
        return (f"the lockstep batch driver runs diffusion, curvature, elastic and fluid, not "
                f"{cfg.method.name}: its demons driver is ROADMAP A15 part 2")
    if cfg.method != Method.FLUID:
        return None
    if cfg.navier_lame_solver != "sor" or cfg.sor_ordering != "redblack":
        return (f"the lockstep fluid driver runs the red-black SOR sweep (B7's pair axis), not "
                f"navier_lame_solver={cfg.navier_lame_solver!r} with "
                f"sor_ordering={cfg.sor_ordering!r}")
    if dims is not None and max(dims) > _DERIV_BARRIER_MIN_EXTENT:
        return (f"the lockstep fluid driver runs levels up to {_DERIV_BARRIER_MIN_EXTENT} a "
                f"side, not {tuple(dims)}: past it a level takes the two-pass step (B8 + B9), "
                f"which has no pair axis")
    return None


def _register_batch_impl(irefs, imovs, cfg: RegConfig, initial_motions=None):
    """``_register_impl`` over a stack of pairs in lockstep, the counterpart
    of the JAX package's ``jax.vmap(_register_impl)``: ``irefs``, ``imovs
    [B, nx, ny]``, ``initial_motions [B, 2, nx, ny]`` or None. The levels
    and refinements advance together; within a refinement each pair stops
    on its own, in the level loop ``register`` runs on a stack of one
    (``_solve_level_blocked``) or, for fluid, in the lockstep fluid loop
    (``_solve_level_fluid_batch``: one host read an iteration for all the
    pairs still iterating), so every pair's result equals its own
    ``register``'s bit for bit. Diffusion, curvature, elastic and fluid;
    fluid with the red-black SOR sweep up to an extent of
    ``_DERIV_BARRIER_MIN_EXTENT``, past which ``register_batch`` maps
    (``lockstep_refusal``)."""
    why = lockstep_refusal(cfg, tuple(irefs.shape[1:]))
    if why is not None:
        raise NotImplementedError(why)
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
        if cfg.method == Method.FLUID:
            u_s, level_traces = _solve_level_fluid_batch(u_s, pyr_ref[s], pyr_mov[s], cfg,
                                                         int(cfg.niter[s]), s)
        else:
            u_s, level_traces = _solve_level_variational(
                u_s, pyr_ref[s], pyr_mov[s], cfg, int(cfg.niter[s]), s, batch=True)
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
