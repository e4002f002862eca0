"""Reductions and pointwise normalizations over fields (PyTorch port of
``opticalflow2d_tpu.ops.reduce``)."""

from __future__ import annotations

import torch


def motion_norm(u: torch.Tensor) -> torch.Tensor:
    """Mean per-pixel magnitude: ``mean_i sqrt(ux_i^2 + uy_i^2)``
    (reference ``src/Motion.cpp:42-49``)."""
    mag = torch.sqrt(u[..., 0, :, :] ** 2 + u[..., 1, :, :] ** 2)
    return torch.mean(mag, dim=(-2, -1))


def motion_maxabs(u: torch.Tensor, bug: bool = False) -> torch.Tensor:
    """Maximum per-pixel magnitude. ``bug=True`` reproduces the reference
    defect that sums the y component twice (``src/Motion.cpp:51-58``)."""
    if bug:
        normsq = u[..., 1, :, :] ** 2 + u[..., 1, :, :] ** 2
    else:
        normsq = u[..., 0, :, :] ** 2 + u[..., 1, :, :] ** 2
    return torch.sqrt(torch.amax(normsq, dim=(-2, -1)))


def normalize_minmax(image: torch.Tensor) -> torch.Tensor:
    """Min-max normalize to [0, 1] (reference ``src/Image.cpp:107-116``,
    with the true max where the reference's starts from 0)."""
    lo = torch.amin(image, dim=(-2, -1), keepdim=True)
    hi = torch.amax(image, dim=(-2, -1), keepdim=True)
    return (image - lo) / (hi - lo)


def ssd(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Sum of squared differences over the trailing two axes."""
    d = a - b
    return torch.sum(d * d, dim=(-2, -1))
