"""Batched registration: a stack of pairs in one call (PyTorch port of
``opticalflow2d_tpu.parallel.batch``).

Two ways to run a batch, as in the JAX package:

- ``impl="vmap"``: the lockstep driver (``engine.registration.
  _register_batch_impl``, the counterpart of ``jax.vmap(_register_impl)``).
  Its level loop is the one ``register`` runs on a stack of one pair
  (``_solve_level_blocked``: the derivatives' kernel U2, the one-block
  lookahead): every level launches its kernels once for all the pairs
  still iterating and reads all their Logger sums in one host read a
  block; each pair keeps its own stop and count, and leaves the launches
  once it stops. Diffusion, curvature and elastic. Where JAX's vmap
  executes both branches of every ``lax.cond`` under a mask, a stopped
  pair here costs nothing.
- ``impl="map"``: each pair through the single-pair ``_register_impl`` in
  turn, as ``lax.map`` does; every family.

Fluid and demons take map: their loops read the device once an iteration
per pair and branch on it (regrids, the exp map's squarings), and JAX's own
docstring calls vmap counterproductive for them; their lockstep drivers are
ROADMAP A15 part 2. Either way every pair's result equals its own
``register``'s, bit for bit.

A mesh's ``"data"`` axis splits the batch into one contiguous slice a row,
registered on the row's first device (``Mesh.data_devices``); one process
drives the rows one after another.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from opticalflow2d_tpu_torch.config import Method, RegConfig
from opticalflow2d_tpu_torch.engine.registration import (
    LevelTrace,
    RegistrationResult,
    _register_batch_impl,
    _register_impl,
    resolve_device,
)
from opticalflow2d_tpu_torch.parallel.mesh import Mesh
from opticalflow2d_tpu_torch.utils.profiling import entry

# Methods whose inner loops branch on a host read an iteration (regrids,
# the exp map), which the JAX package's vmap forces to execute both ways.
_COND_HEAVY = (Method.THIRIONS_DEMONS, Method.DIFFEOMORPHIC_DEMONS, Method.FLUID)
_IMPLS = ("vmap", "map")


def _resolve_impl(cfg: RegConfig, impl: str) -> str:
    """Resolve ``impl="auto"``: map for fluid and demons, vmap for the
    variational families. This is the JAX package's rule for a config with
    ``warp_halo > 0`` and no Pallas: the port has neither knob (its gather
    is exact and its kernels run under the lockstep driver), so only the
    method decides."""
    if impl != "auto":
        return impl
    return "map" if cfg.method in _COND_HEAVY else "vmap"


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
        elastic), ``"map"`` (each pair in turn; every family) or
        ``"auto"`` (``_resolve_impl``: map for fluid and demons).
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
    impl = _resolve_impl(cfg, impl)
    if impl not in _IMPLS:
        raise ValueError(f"unknown impl {impl!r}")
    if impl == "vmap" and cfg.method in _COND_HEAVY:
        raise NotImplementedError(
            f"impl='vmap' runs diffusion, curvature and elastic; the lockstep driver of "
            f"{cfg.method.name} is ROADMAP A15 part 2 (impl='map' or 'auto' runs it)")
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
