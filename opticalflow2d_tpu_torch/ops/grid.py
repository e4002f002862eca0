"""Finite-difference stencils (PyTorch port of ``opticalflow2d_tpu.ops.grid``).

One-sided borders for the first derivatives and a zero border for the
quasi-laplacian, as the reference's inline stencils (``src/gradients.h:9-80``).
Every function works on the trailing two axes ``[..., nx, ny]`` (axis -2 is
"x", axis -1 is "y") and keeps the JAX package's order of operations.
"""

from __future__ import annotations

import torch


def partial_x(f: torch.Tensor) -> torch.Tensor:
    """d/dx: central difference, one-sided at the x borders
    (reference ``src/gradients.h:9-19``)."""
    interior = (f[..., 2:, :] - f[..., :-2, :]) * 0.5
    first = f[..., 1:2, :] - f[..., 0:1, :]
    last = f[..., -1:, :] - f[..., -2:-1, :]
    return torch.cat([first, interior, last], dim=-2)


def partial_x_rows(fp: torch.Tensor, gi: torch.Tensor, nx: int) -> torch.Tensor:
    """d/dx of the rows of ``fp [..., m + 2, ny]`` between its first and
    last, a strip of an image of ``nx`` rows with one neighbour row a side:
    central, one-sided where the global row index ``gi`` (broadcastable to
    ``[m, ny]``) is 0 or ``nx - 1``. Equals ``partial_x`` of the image on
    those rows."""
    central = (fp[..., 2:, :] - fp[..., :-2, :]) * 0.5
    first = fp[..., 2:, :] - fp[..., 1:-1, :]
    last = fp[..., 1:-1, :] - fp[..., :-2, :]
    return torch.where(gi == 0, first, torch.where(gi == nx - 1, last, central))


def partial_y(f: torch.Tensor) -> torch.Tensor:
    """d/dy: central difference, one-sided at the y borders
    (reference ``src/gradients.h:21-32``)."""
    interior = (f[..., :, 2:] - f[..., :, :-2]) * 0.5
    first = f[..., :, 1:2] - f[..., :, 0:1]
    last = f[..., :, -1:] - f[..., :, -2:-1]
    return torch.cat([first, interior, last], dim=-1)


def qlaplacian(f: torch.Tensor) -> torch.Tensor:
    """Quasi-laplacian: 4-neighbour average in the interior, zero on the
    borders (reference ``src/gradients.h:72-80``)."""
    out = torch.zeros_like(f)
    out[..., 1:-1, 1:-1] = (
        f[..., :-2, 1:-1] + f[..., 2:, 1:-1] + f[..., 1:-1, :-2] + f[..., 1:-1, 2:]
    ) * 0.25
    return out


def spatial_gradient(image: torch.Tensor) -> torch.Tensor:
    """Stack (d/dx, d/dy) of an image into a motion-shaped ``[2, nx, ny]``
    tensor (reference ``src/regularization/IterativeSolver.cpp:22-44``)."""
    return torch.stack([partial_x(image), partial_y(image)], dim=-3)


def jacobian_det(u: torch.Tensor) -> torch.Tensor:
    """Jacobian determinant of the deformation x + u,
    ``(1+du_x/dx)(1+du_y/dy) - (du_y/dx)(du_x/dy)``
    (reference ``src/Image.cpp:189-218``)."""
    ux, uy = u[..., 0, :, :], u[..., 1, :, :]
    return (1.0 + partial_x(ux)) * (1.0 + partial_y(uy)) - partial_x(uy) * partial_y(ux)
