"""Plain reference of Thirion's demons registration, in float32 PyTorch: the
level loop of ``ImageRegistrationDemons.cpp:86-137`` over the iteration of
``DemonsThirions.cpp:18-42``.

A level's refinement warps the moving image by the level's motion ``u``
once (``Iaux``); then each iteration, at the estimate ``e`` (zero at the
refinement's start):

1. warp ``Iaux`` by ``e`` (``Image.cpp:119-182``) and take the derivatives
   ``[dI/dx, dI/dy, I - Iref]`` of the warped image (``IterativeSolver.cpp:
   22-56``);
2. the demons force ``c = -grad I (I - Iref) / (|grad I|^2 + (I - Iref)^2
   sigma_i^2 / sigma_x^2)`` (``Demons.cpp:34-64``);
3. ``c`` smoothed by the Gaussian of ``sigma_fluid`` over ``kernelwidth``
   taps, renormalised by the weights inside the image (``Field.tpp:210,
   234-265``);
4. accumulated: ``e <- c + e(x + c)`` by composition (``Motion.cpp:113``),
   or ``e <- e + c`` where the accumulation setting is 1 (addition);
5. ``e`` smoothed by the Gaussian of ``sigma_diffusion``.

The Logger (``Logger.cpp:30-60``) takes the step's input as its previous
estimate and stops the refinement after the third iteration once the mean
magnitude of the step over that of the previous estimate is below 1e-3;
the estimate is then composed into the level's motion. Each level is
downsampled straight from full resolution, the coarsest started at zero,
and its motion brought back to full resolution after its solve
(``ImageRegistration.cpp:103-151``): ``common.register``.

Departures from the upstream sources, each the program's documented
default: the force divides 0 by 0 into 0 (the upstream divides unguarded:
at a flat, matched pixel it has no information); the Gaussian clips its
taps at the image's edges along each axis (the upstream checks its bounds
on the flat index, so its x-edge taps wrap into the neighbouring row,
``Field.tpp:245-246``), and is computed as the separable product it
equals: the unnormalised float32 taps along x, then along y, each added in
tap order, over the product of the two axes' in-image tap sums (the
upstream adds the k x k products of its normalised kernel; a sum over taps
is a reduction, whose order may differ). Matrix products and convolutions
are kept out of TF32.
"""

from __future__ import annotations

import numpy as np
import torch

from torch_bench.reference import common

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

ADDITION = 1  # MotionAccumulation (SolverOptions.h:4-8): 0 composition, 1 addition


def gaussian_taps(sigma: float, width: int) -> list:
    """``exp(-(t - c)^2 / (2 sigma^2))`` for ``t`` in ``0 .. width - 1``,
    ``c = (width - 1) // 2`` (``Kernel.cpp:52-61``), in double, each
    rounded to float32 once."""
    c = (width - 1) // 2
    t = np.arange(width, dtype=np.float64)
    return [float(v) for v in np.exp(-((t - c) ** 2) / (2.0 * sigma * sigma)).astype(np.float32)]


def _taps_along(f: torch.Tensor, taps: list, axis: int) -> torch.Tensor:
    """``sum_t taps[t] f(x + t - c)`` along ``axis``, 0 outside the image,
    the terms added in tap order."""
    c = (len(taps) - 1) // 2
    n = f.shape[axis]
    pad = [0, 0] * (f.dim() - 1 - axis % f.dim()) + [c, c]
    fp = torch.nn.functional.pad(f, pad)
    total = fp.narrow(axis, 0, n) * taps[0]
    for t in range(1, len(taps)):
        total = total + fp.narrow(axis, t, n) * taps[t]
    return total


def gaussian(f: torch.Tensor, sigma: float, width: int) -> torch.Tensor:
    """The renormalised Gaussian of ``f [..., nx, ny]`` (module docstring)."""
    taps = gaussian_taps(sigma, width)
    num = _taps_along(_taps_along(f, taps, -2), taps, -1)
    nx, ny = f.shape[-2:]
    ones = lambda n: torch.ones(n, dtype=f.dtype, device=f.device)
    den_x, den_y = _taps_along(ones(nx), taps, 0), _taps_along(ones(ny), taps, 0)
    return num / (den_x[:, None] * den_y[None, :])


def force(g: torch.Tensor, sigma_i: float, sigma_x: float) -> torch.Tensor:
    """The demons force of the derivatives ``g = [dI/dx, dI/dy, I - Iref]``,
    ``sigma_i^2`` and ``sigma_x^2`` each rounded to float32 once; 0 where
    the denominator is 0."""
    gx, gy, it = g[0], g[1], g[2]
    den = gx * gx + gy * gy + it * it * common.f32(sigma_i * sigma_i) / common.f32(
        sigma_x * sigma_x)
    num = g[:2] * it * -1.0
    return torch.where(den > 0, num / torch.where(den > 0, den, 1.0), 0.0)


def register(iref, imov, settings: dict, store=lambda x: x):
    """``(motion [2, nx, ny], [Solve, ...])`` of one pair, coarse to fine."""
    sigma_i, sigma_x, sigma_d, sigma_f, width, accumulation = settings["regparams"]
    width = int(width)
    addition = int(accumulation) == ADDITION
    tol = np.float32(settings.get("convergence_tol", 0.001))

    def solve_level(u, iref_s, imov_s, niter, scale):
        solves = []
        for _ in range(settings["nrefine"]):
            iaux = store(common.warp(imov_s, u))

            def step(est):
                g = common.derivatives(iref_s, common.warp(iaux, est), store)
                c = gaussian(force(g, sigma_i, sigma_x), sigma_f, width)
                new = est + c if addition else common.compose(est, c)
                return gaussian(new, sigma_d, width)

            est, it = common.logger_solve(torch.zeros_like(u), step, niter, tol, store)
            u = store(common.compose(u, est))
            solves.append(common.Solve(scale, it, 0))
        return u, solves

    return common.register(iref, imov, settings, solve_level, store)
