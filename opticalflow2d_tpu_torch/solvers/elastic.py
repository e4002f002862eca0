"""Elastic (Navier-Lame) solver by SOR (PyTorch port of
``opticalflow2d_tpu.solvers.elastic``).

The reference performs one in-place lexicographic Gauss-Seidel/SOR sweep over
the interior points per iteration (``src/regularization/OpticalFlow/
OpticalFlowElastic.cpp:21-55``). ``ordering="redblack"`` (the default) runs
two masked half-sweeps over the checkerboard colours instead: every candidate
of a half-sweep is computed from the field as it stood, then the colour's
cells take theirs. It is the plain version of the elastic block kernel
(``kernels.elastic_block``). ``ordering="lexicographic"`` reproduces the
reference's sequential sweep exactly with an anti-diagonal wavefront; it is
plain PyTorch on every device, slow by design, for parity runs.

``reference_stencil=True`` (default) reproduces the reference's
discretization, including the asymmetric ``(mu+lambda)`` term of the
y-component that reads x-direction neighbours (``OpticalFlowElastic.cpp:
46-49``). ``False`` selects the symmetric Navier-Lame operator.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from opticalflow2d_tpu_torch.solvers.base import Derivatives, lssd_force


class SorScalars(NamedTuple):
    """The SOR update's scalars, each rounded to float32 once from its
    double-precision value, as JAX rounds a Python scalar where it meets a
    float32 array: ``mu``, ``mu + lambda``, ``1 - omega`` and
    ``inv_diag = omega / (-6 mu - 2 lambda)``."""

    mu: float
    mpl: float
    omw: float
    inv_diag: float


def sor_scalars(mu: float, lam: float, omega: float) -> SorScalars:
    exact = (mu, mu + lam, 1.0 - omega, omega / (-6.0 * mu - 2.0 * lam))
    return SorScalars(*(float(np.float32(x)) for x in exact))


def _gs_candidate(x: torch.Tensor, b: torch.Tensor, s: SorScalars,
                  reference_stencil: bool) -> torch.Tensor:
    """The SOR update value at every interior pixel ``[2, nx-2, ny-2]``,
    computed from the current field ``x [2, nx, ny]`` and right-hand side
    ``b``, in the JAX package's order of operations."""

    def comp(c: int) -> torch.Tensor:
        xc, xo = x[c], x[1 - c]
        xp, xm = xc[2:, 1:-1], xc[:-2, 1:-1]
        yp, ym = xc[1:-1, 2:], xc[1:-1, :-2]
        lap4 = xp + xm + yp + ym
        cross = 0.25 * (xo[2:, 2:] - xo[:-2, 2:] - xo[2:, :-2] + xo[:-2, :-2])
        # The x-component always takes x-direction neighbours; the
        # reference's y-component does too (the asymmetry).
        second = xp + xm if c == 0 or reference_stencil else yp + ym
        num = b[c, 1:-1, 1:-1] - s.mu * lap4 - s.mpl * (second + cross)
        return s.omw * xc[1:-1, 1:-1] + s.inv_diag * num

    return torch.stack([comp(0), comp(1)])


@functools.lru_cache(maxsize=64)
def _color_masks(nx: int, ny: int):
    """Red ((i + j) even) and black interior masks ``[nx-2, ny-2]`` as
    numpy arrays (cached)."""
    i = np.arange(1, nx - 1)[:, None]
    j = np.arange(1, ny - 1)[None, :]
    red = (i + j) % 2 == 0
    return red, ~red


def _masked_update(x: torch.Tensor, cand: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    out = x.clone()
    out[:, 1:-1, 1:-1] = torch.where(mask, cand, x[:, 1:-1, 1:-1])
    return out


def sor_sweep(x: torch.Tensor, b: torch.Tensor, mu: float, lam: float, omega: float,
              reference_stencil: bool = True, ordering: str = "redblack") -> torch.Tensor:
    """One SOR sweep of the Navier-Lame system ``A x = b`` on the interior
    points of ``x [2, nx, ny]``; the borders are untouched.

    ``"lexicographic"``: for the order i outer, j inner, the update at
    (i, j) reads updated values at (i-1, j-1), (i-1, j), (i-1, j+1),
    (i, j-1) and old values elsewhere, so the diagonals ``d = 2i + j`` form
    a valid dependency frontier; updating one diagonal at a time gives the
    sequential sweep's floating-point sequence exactly."""
    s = sor_scalars(mu, lam, omega)
    nx, ny = x.shape[-2], x.shape[-1]
    if ordering == "redblack":
        red_np, black_np = _color_masks(nx, ny)
        red = torch.from_numpy(red_np).to(x.device)
        black = torch.from_numpy(black_np).to(x.device)
        x = _masked_update(x, _gs_candidate(x, b, s, reference_stencil), red)
        return _masked_update(x, _gs_candidate(x, b, s, reference_stencil), black)
    if ordering != "lexicographic":
        raise ValueError(f"unknown SOR ordering {ordering!r}")
    i = torch.arange(1, nx - 1, device=x.device)[:, None]
    j = torch.arange(1, ny - 1, device=x.device)[None, :]
    diag = 2 * i + j
    # Interior diagonals run from 2*1+1 to 2*(nx-2)+(ny-2).
    for d in range(3, 2 * (nx - 2) + (ny - 2) + 1):
        x = _masked_update(x, _gs_candidate(x, b, s, reference_stencil), diag == d)
    return x


def elastic_step(u: torch.Tensor, d: Derivatives, mu: float, lam: float, omega: float,
                 reference_stencil: bool = True, ordering: str = "redblack") -> torch.Tensor:
    """One elastic iteration: the force at the current motion, then one SOR
    sweep on the motion itself (reference ``OpticalFlowElastic.cpp:13-19``)."""
    f = lssd_force(d, u)
    return sor_sweep(u, f, mu, lam, omega, reference_stencil, ordering)
