"""Batched registration: a stack of pairs in one call (PyTorch port of
``opticalflow2d_tpu.parallel.batch``).

Two ways to run a batch, as in the JAX package:

- ``impl="vmap"``: the lockstep driver (``engine.registration.
  _register_batch_impl``, the counterpart of ``jax.vmap(_register_impl)``).
  Its level loop for diffusion, curvature and elastic is the one
  ``register`` runs on a stack of one pair (``_solve_level_blocked``: the
  derivatives' kernel U2, the one-block lookahead): every level launches
  its kernels once for all the pairs still iterating and reads all their
  Logger sums in one host read a block. Fluid has its own lockstep loop
  (``_solve_level_fluid_batch``): B7 and B5 once an iteration for all the
  pairs still iterating, one host read an iteration of their metrics, and
  the pairs that regrid at an iteration regridded together. Demons have
  theirs too (``_solve_level_demons_batch``): one warp a refinement, then
  B10's pair axis once an iteration for the pairs still iterating and one
  host read of their Logger sums, for Thirion (by composition or
  addition) and diffeomorphic demons in the exp map's identity regime.
  Each pair keeps its own stop, counts and regrids, and leaves the
  launches once it stops. Where JAX's vmap executes both branches of every ``lax.cond``
  under a mask, a stopped pair here costs nothing.
- ``impl="map"``: each pair through the single-pair ``_register_impl`` in
  turn, as ``lax.map`` does; every family.

What the lockstep loops do not run takes map (``lockstep_refusal``):
diffeomorphic demons outside the exp map's identity regime (B11, the exp
map and B12 have no pair axis, ROADMAP A15 part 2), demons on the op chain
(``conv_flatwrap``, or a kernelwidth whose tile does not fit B10), and a
fluid configuration with another solver than the red-black SOR sweep or a
level past an extent of 8192, whose two-pass step has no pair axis.
Either way every pair's result equals its own ``register``'s, bit for
bit.

A mesh's ``"data"`` axis splits the batch into one contiguous slice a row,
registered on the row's first device (``Mesh.data_devices``); one process
drives the rows one after another.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from opticalflow2d_tpu_torch.config import RegConfig
from opticalflow2d_tpu_torch.engine.registration import (
    LevelTrace,
    RegistrationResult,
    _register_batch_impl,
    _register_impl,
    lockstep_refusal,
    resolve_device,
)
from opticalflow2d_tpu_torch.parallel.mesh import Mesh
from opticalflow2d_tpu_torch.utils.profiling import entry

_IMPLS = ("vmap", "map")


def _resolve_impl(cfg: RegConfig, impl: str, dims=None) -> str:
    """Resolve ``impl="auto"`` for images of ``dims`` (``None``: any size):
    vmap where the lockstep driver runs the configuration
    (``lockstep_refusal``: diffusion, curvature, elastic, fluid with the
    red-black SOR sweep up to an extent of 8192, Thirion demons, and
    diffeomorphic demons in the exp map's identity regime, each demons
    configuration on B10's onepass route), map otherwise (the two-kernel
    and op-chain demons routes, other fluid configurations). This departs
    from the JAX
    package's rule, which maps fluid and demons for a config with
    ``warp_halo > 0`` and no Pallas because its vmap runs every
    ``lax.cond``'s both branches and every pair to the slowest one's stop:
    here a stopped pair leaves the launches and a regrid runs only for the
    pairs that take it, so fluid and demons lose nothing in lockstep and
    save a host read an iteration per pair. The port has neither of JAX's knobs
    (its gather is exact and its kernels run under the lockstep driver),
    so the configuration alone decides."""
    if impl != "auto":
        return impl
    return "map" if lockstep_refusal(cfg, dims) is not None else "vmap"


def _map_local(irefs, imovs, cfg: RegConfig, u0s=None) -> RegistrationResult:
    """Each pair through the single-pair driver in turn, stacked."""
    return _stack_results([
        _register_impl(irefs[i], imovs[i], cfg, None if u0s is None else u0s[i])
        for i in range(irefs.shape[0])])


def _stack_results(results: List[RegistrationResult]) -> RegistrationResult:
    """Single-pair results stacked on a leading pair axis, as the JAX
    package's vmapped and mapped results hold it on every leaf."""
    traces = []
    for level in zip(*(r.traces for r in results)):
        traces.append(LevelTrace(
            scale=level[0].scale,
            errors=torch.stack([t.errors for t in level]),
            iterations=torch.tensor([t.iterations for t in level], dtype=torch.int64),
            regrids=torch.tensor([t.regrids for t in level], dtype=torch.int64),
            fallbacks=torch.tensor([t.fallbacks for t in level], dtype=torch.int64)))
    coarse = [r.coarse_motion for r in results]
    return RegistrationResult(
        motion=torch.stack([r.motion for r in results]), traces=tuple(traces),
        coarse_motion=None if any(c is None for c in coarse) else torch.stack(coarse))


def _concat(parts: List[RegistrationResult], device: torch.device) -> RegistrationResult:
    """The data rows' results joined along the pair axis on ``device``."""
    if len(parts) == 1:
        return parts[0]

    def cat(xs):
        return torch.cat([x.to(device) for x in xs])

    traces = tuple(
        LevelTrace(level[0].scale, cat([t.errors for t in level]),
                   cat([t.iterations for t in level]), cat([t.regrids for t in level]),
                   cat([t.fallbacks for t in level]))
        for level in zip(*(p.traces for p in parts)))
    return RegistrationResult(motion=cat([p.motion for p in parts]), traces=traces,
                              coarse_motion=cat([p.coarse_motion for p in parts]))


def register_batch(irefs, imovs, cfg: RegConfig, mesh: Optional[Mesh] = None,
                   impl: str = "auto", initial_motions=None,
                   device=None) -> RegistrationResult:
    """Register a batch of pairs.

    Args:
      irefs, imovs: ``[B, nx, ny]`` image stacks, tensors or arrays.
      cfg: registration configuration.
      mesh: optional mesh; the batch is split over its ``"data"`` rows (B
        must be divisible by their number), each row's pairs run on the
        row's first device.
      impl: ``"vmap"`` (the lockstep driver: diffusion, curvature,
        elastic, fluid with the red-black SOR sweep up to an extent of
        8192, and demons on B10's onepass route: Thirion, and
        diffeomorphic in the exp map's identity regime), ``"map"`` (each
        pair in turn; every family) or ``"auto"`` (``_resolve_impl``:
        vmap where the lockstep driver runs, map for the other demons
        routes and other fluid configurations).
      initial_motions: optional ``[B, 2, nx, ny]`` warm-start fields (for
        example the previous frames' solutions of a sequence).
      device: where the batch runs without a mesh; ``None`` means CUDA
        (and raises on a host without it), ``"cpu"`` the kernels' plain
        versions. With a mesh the rows' devices are used.

    Returns:
      ``RegistrationResult`` with a leading pair axis on every leaf:
      ``motion [B, 2, nx, ny]``, each ``LevelTrace``'s ``errors [B,
      niter]`` and ``iterations``, ``regrids``, ``fallbacks`` as ``[B]``
      tensors, ``coarse_motion [B, 2, ...]``; on the first row's device.
    """
    with entry("register"):
        return _register_batch(irefs, imovs, cfg, mesh, impl, initial_motions, device)


def _register_batch(irefs, imovs, cfg: RegConfig, mesh: Optional[Mesh], impl: str,
                    initial_motions, device) -> RegistrationResult:
    if mesh is not None and device is not None:
        raise ValueError("pass a mesh or a device, not both: a mesh's rows name their devices")
    devices = mesh.data_devices() if mesh is not None else [resolve_device(device)]
    dtype = cfg.torch_dtype
    irefs = torch.as_tensor(irefs, dtype=dtype)
    imovs = torch.as_tensor(imovs, dtype=dtype)
    if irefs.dim() != 3 or irefs.shape != imovs.shape:
        raise ValueError(
            f"expected matching [B, nx, ny] stacks, got {tuple(irefs.shape)} vs "
            f"{tuple(imovs.shape)}")
    b = irefs.shape[0]
    if b % len(devices) != 0:
        raise ValueError(f"batch {b} not divisible by data-axis size {len(devices)}")
    dims = tuple(irefs.shape[1:])
    impl = _resolve_impl(cfg, impl, dims)
    if impl not in _IMPLS:
        raise ValueError(f"unknown impl {impl!r}")
    why = lockstep_refusal(cfg, dims) if impl == "vmap" else None
    if why is not None:
        raise NotImplementedError(f"impl='vmap': {why} (impl='map' or 'auto' runs it)")
    u0s = None
    if initial_motions is not None:
        u0s = torch.as_tensor(initial_motions, dtype=dtype)
        if tuple(u0s.shape) != (b, 2) + tuple(irefs.shape[1:]):
            raise ValueError(f"initial_motions must be [B, 2, nx, ny], got {tuple(u0s.shape)}")
    per = b // len(devices)
    parts = []
    for r, dev in enumerate(devices):
        rows = slice(r * per, (r + 1) * per)
        ref, mov = irefs[rows].to(dev), imovs[rows].to(dev)
        u0 = None if u0s is None else u0s[rows].to(dev)
        if impl == "vmap":
            parts.append(_register_batch_impl(ref, mov, cfg, u0))
        else:
            parts.append(_map_local(ref, mov, cfg, u0))
    return _concat(parts, devices[0])
