"""Shared solver primitives (PyTorch port of ``opticalflow2d_tpu.solvers.base``).

- ``derivatives``: gradient of the (warped) moving image and the temporal
  difference (reference ``src/regularization/IterativeSolver.cpp:22-56``).
- ``lssd_force``: the linearized-SSD force ``f = grad(I) * (It + u . grad(I))``
  (reference ``src/regularization/OpticalFlow/OpticalFlow.cpp:15-39``).
- ``demons_force``: Thirion's demons correspondence force
  (reference ``src/regularization/Demons/Demons.cpp:34-64``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from opticalflow2d_tpu_torch.ops.grid import spatial_gradient


class Derivatives(NamedTuple):
    """Per-level image derivatives: ``grad_i [2, nx, ny]`` (gradient of the
    warped moving image) and ``it [nx, ny]`` (Imov - Iref)."""

    grad_i: torch.Tensor
    it: torch.Tensor


def derivatives(iref: torch.Tensor, imov: torch.Tensor) -> Derivatives:
    """grad(Imov) by central differences and It = Imov - Iref; the gradient
    is taken on the moving (warped) image."""
    return Derivatives(grad_i=spatial_gradient(imov), it=imov - iref)


def lssd_force(d: Derivatives, u: torch.Tensor) -> torch.Tensor:
    """Linearized-SSD force ``grad(I) * (It + ux*dIx + uy*dIy)``, ``[2, nx, ny]``,
    or ``[B, 2, nx, ny]`` over a leading pair axis (the lockstep batch
    driver's curvature step), elementwise alike."""
    gi = d.grad_i
    inner = d.it + u[..., 0, :, :] * gi[..., 0, :, :] + u[..., 1, :, :] * gi[..., 1, :, :]
    return gi * inner[..., None, :, :]


def demons_force(d: Derivatives, sigma_i: float, sigma_x: float) -> torch.Tensor:
    """Demons update ``-grad(I) * It / (|grad(I)|^2 + It^2 sigma_i^2 / sigma_x^2)``.

    The reference divides unguarded; 0/0 at flat, matched pixels is defined
    here as 0, the limit with no information.
    """
    den = (
        d.grad_i[0] ** 2
        + d.grad_i[1] ** 2
        + d.it**2 * (sigma_i * sigma_i) / (sigma_x * sigma_x)
    )[None]
    num = d.grad_i * d.it[None] * -1.0
    return torch.where(den > 0, num / torch.where(den > 0, den, 1.0), 0.0)
