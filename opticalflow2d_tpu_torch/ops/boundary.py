"""Boundary conditions on motion fields (PyTorch port of
``opticalflow2d_tpu.ops.boundary``).

Equivalents of ``Motion::Neumann_boundaryconditions`` /
``Motion::Dirichlet_boundaryconditions`` (``src/Motion.cpp:181-251``). The
reference never calls them; they are the intended semantics, copy-from-
interior (Neumann, zero flux) and zero (Dirichlet) borders, for callers
that write their own solver loops.
"""

from __future__ import annotations

import torch


def dirichlet_boundary(u: torch.Tensor) -> torch.Tensor:
    """Zero the border ring of ``[..., nx, ny]``."""
    out = u.clone()
    out[..., 0, :] = 0
    out[..., -1, :] = 0
    out[..., :, 0] = 0
    out[..., :, -1] = 0
    return out


def neumann_boundary(u: torch.Tensor) -> torch.Tensor:
    """Zero-flux border: each border pixel copies its inward neighbour,
    corners copy the inward diagonal."""
    out = u.clone()
    out[..., 0, :] = u[..., 1, :]
    out[..., -1, :] = u[..., -2, :]
    out[..., :, 0] = out[..., :, 1]
    out[..., :, -1] = out[..., :, -2]
    return out
