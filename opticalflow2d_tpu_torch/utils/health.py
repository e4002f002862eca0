"""Numerical-health checks (PyTorch port of ``opticalflow2d_tpu.utils.
health``): the risks of a registration are NaN or Inf propagation and a
silently diverging solve.

``debug_nans`` is the counterpart of the JAX package's scoped
``jax_debug_nans``: while it is on, the level drivers check each
refinement's increment and the composed motion field (one host read a
refinement, and only under the context) and raise ``FloatingPointError``
naming the scale and the refinement where a non-finite value first shows.
The increment is checked as well because the compose drops a non-finite
increment (its sample counts as out of bounds and keeps the old field).
"""

from __future__ import annotations

import contextlib
import contextvars

import numpy as np
import torch

_DEBUG_NANS = contextvars.ContextVar("opticalflow2d_debug_nans", default=False)


@contextlib.contextmanager
def debug_nans(enable: bool = True):
    """Check every level's field for NaN and Inf inside the block (see the
    module docstring); the caller's setting is restored after it."""
    token = _DEBUG_NANS.set(bool(enable))
    try:
        yield
    finally:
        _DEBUG_NANS.reset(token)


def check_level_field(scale: int, refine: int, u_inc: torch.Tensor, u: torch.Tensor) -> None:
    """Under ``debug_nans``, raise unless refinement ``refine`` of scale
    ``scale`` left a finite increment ``u_inc`` and field ``u``; otherwise
    do nothing (and read nothing from the device)."""
    if not _DEBUG_NANS.get():
        return
    bad = (~torch.isfinite(u_inc)).sum() + (~torch.isfinite(u)).sum()
    if int(bad):
        raise FloatingPointError(
            f"non-finite motion at scale {scale}, refinement {refine}: {int(bad)} values "
            f"of the increment and the field (shape {tuple(u.shape)})")


def _leaves(tree):
    """The tensors and arrays of a nest of tuples, lists and dicts (a
    ``RegistrationResult`` and its traces included), in order; ``None``
    skipped, as in JAX's tree leaves of such a nest."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _leaves(tree[key])
    elif isinstance(tree, (tuple, list)):
        for item in tree:
            yield from _leaves(item)
    elif tree is not None:
        yield tree


def assert_finite(tree, name: str = "value") -> None:
    """Host-side finiteness check over a nest of tensors or arrays (after
    the run; during it use ``debug_nans``)."""
    for i, leaf in enumerate(_leaves(tree)):
        if isinstance(leaf, torch.Tensor):
            leaf = leaf.detach().cpu()
        arr = np.asarray(leaf, dtype=np.float64)
        if not np.isfinite(arr).all():
            bad = int((~np.isfinite(arr)).sum())
            raise FloatingPointError(
                f"{name}: leaf {i} has {bad} non-finite values (shape {arr.shape})")


def divergence_guard(errors, window: int = 5, factor: float = 10.0) -> bool:
    """True if a convergence trace is diverging: the mean of its last
    ``window`` nonzero relative-step errors exceeds ``factor`` times the
    mean of its first ``window``."""
    if isinstance(errors, torch.Tensor):
        errors = errors.detach().cpu()
    e = np.asarray(errors)
    nz = e[e > 0]
    if len(nz) < 2 * window:
        return False
    return float(nz[-window:].mean()) > factor * float(nz[:window].mean())
