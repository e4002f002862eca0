"""The plain reference's shared parts: the pyramid, the bilinear warp and
composition, the image derivatives, the Logger and the level loop of the
upstream C++ library (``tjwdraper/OpticalFlow2d``), in float32 PyTorch.

Written from the upstream sources' semantics and cited lines, in plain
tensor operations, with no kernel, cache or batching, and importing
nothing of the program under test. Each elementwise chain keeps one fixed
order of operations, the one the upstream loops evaluate, so that two
correct float32 implementations round alike; only reductions (sums over
an image) may add in another order.

``store`` is applied to every field as it is stored: the identity for the
reference, a rounding to a lower precision for the control
(``torch_bench.correct``).
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple, Tuple

import numpy as np
import torch

Store = Callable[[torch.Tensor], torch.Tensor]


def f32(x: float) -> float:
    """``x`` rounded to float32, as the upstream float fields hold it."""
    return float(np.float32(x))


class Solve(NamedTuple):
    """One (level, refinement) solve: its scale, iterations and regrids."""

    scale: int
    iterations: int
    regrids: int


def pyramid_dims(dims, nscales: int) -> List[Tuple[int, int]]:
    """``dims / 2^s`` truncated (``ImageRegistration.cpp:54-61``)."""
    nx, ny = dims
    return [(int(nx / (2.0 ** s)), int(ny / (2.0 ** s))) for s in range(nscales + 1)]


def downsample(image: torch.Tensor, dimout) -> torch.Tensor:
    """Mean over ``fx x fy`` patches anchored at ``(i fx, j fy)``
    (``Field.tpp:76-143``), added patch row by patch row; a 2x2 patch on a
    grid whose width is a power of two adds each row's pair first."""
    nx, ny = image.shape[-2:]
    if max(nx, ny) > 4096:
        raise NotImplementedError("the reference's downsample covers extents up to 4096")
    fx, fy = nx // dimout[0], ny // dimout[1]
    crop = image[..., :dimout[0] * fx, :dimout[1] * fy]
    c = [[crop[..., a::fx, b::fy] for b in range(fy)] for a in range(fx)]
    w = crop.shape[-1]
    if fx == fy == 2 and w & (w - 1) == 0:
        terms = [c[a][0] + c[a][1] for a in range(fx)]
    else:
        terms = [c[a][b] for a in range(fx) for b in range(fy)]
    total = terms[0]
    for t in terms[1:]:
        total = total + t
    return total / (fx * fy)


def _ratio(u: torch.Tensor, dimout) -> torch.Tensor:
    return torch.tensor([dimout[0] / u.shape[-2], dimout[1] / u.shape[-1]],
                        dtype=u.dtype, device=u.device)[:, None, None]


def bilinear(data: torch.Tensor, px: torch.Tensor, py: torch.Tensor):
    """Bilinear taps of ``data [C, nx, ny]`` at ``(px, py)`` with the
    upstream tap rule (``Image.cpp:155-173``): the floor corner always, its
    ``+1`` neighbours only inside the grid. Returns the weighted value, the
    weight and whether the floor corner lies in the grid."""
    nx, ny = data.shape[-2:]
    x0f, y0f = torch.floor(px), torch.floor(py)
    fx, fy = px - x0f, py - y0f
    x0, y0 = x0f.long(), y0f.long()
    inside = (x0 >= 0) & (x0 < nx) & (y0 >= 0) & (y0 < ny)
    hx, hy = x0 < nx - 1, y0 < ny - 1
    w00 = (1.0 - fx) * (1.0 - fy)
    w10 = torch.where(hx, fx * (1.0 - fy), 0.0)
    w01 = torch.where(hy, (1.0 - fx) * fy, 0.0)
    w11 = torch.where(hx & hy, fx * fy, 0.0)
    xa, xb = x0.clamp(0, nx - 1), (x0 + 1).clamp(0, nx - 1)
    ya, yb = y0.clamp(0, ny - 1), (y0 + 1).clamp(0, ny - 1)
    value = (data[:, xa, ya] * w00 + data[:, xb, ya] * w10 + data[:, xa, yb] * w01
             + data[:, xb, yb] * w11)
    return value, w00 + w10 + w01 + w11, inside


def upsample_motion(u: torch.Tensor, dimout) -> torch.Tensor:
    """Corner-anchored bilinear upsample with the weights renormalised,
    each component scaled by the size ratio (``Field.tpp:146-206``,
    ``Motion.cpp:61-85``)."""
    nx, ny = u.shape[-2:]
    kw = dict(dtype=u.dtype, device=u.device)
    px = torch.arange(dimout[0], **kw)[:, None] * torch.tensor(nx / dimout[0], **kw)
    py = torch.arange(dimout[1], **kw)[None, :] * torch.tensor(ny / dimout[1], **kw)
    px, py = torch.broadcast_tensors(px, py)
    value, weight, _ = bilinear(u, px, py)
    return value / torch.where(weight != 0, weight, 1.0) * _ratio(u, dimout)


def downsample_motion(u: torch.Tensor, dimout) -> torch.Tensor:
    """``Motion.cpp:87-111``."""
    return downsample(u, dimout) * _ratio(u, dimout)


def _coords(u: torch.Tensor):
    nx, ny = u.shape[-2:]
    gi = torch.arange(nx, dtype=u.dtype, device=u.device)[:, None]
    gj = torch.arange(ny, dtype=u.dtype, device=u.device)[None, :]
    return gi + u[0], gj + u[1]


def warp(image: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """``I(x + u(x))``; a sample whose floor corner lies outside the grid
    keeps the pixel's own value (``Image.cpp:119-182``)."""
    value, weight, inside = bilinear(image[None], *_coords(u))
    ok = inside & (weight != 0)
    return torch.where(ok, value[0] / torch.where(weight != 0, weight, 1.0), image)


def compose(total: torch.Tensor, inc: torch.Tensor) -> torch.Tensor:
    """``inc + total(x + inc)`` (``Motion::accumulate``, ``Motion.cpp:
    113-178``); outside the grid the old total stays."""
    value, weight, inside = bilinear(total, *_coords(inc))
    warped = value / torch.where(weight != 0, weight, 1.0)
    return torch.where(inside[None], inc + torch.where(weight != 0, warped, 0.0), total)


def partial_x(f: torch.Tensor) -> torch.Tensor:
    """Central difference along axis -2, one-sided at its ends
    (``gradients.h:9-19``)."""
    return torch.cat([f[..., 1:2, :] - f[..., 0:1, :], (f[..., 2:, :] - f[..., :-2, :]) * 0.5,
                      f[..., -1:, :] - f[..., -2:-1, :]], dim=-2)


def partial_y(f: torch.Tensor) -> torch.Tensor:
    """Central difference along axis -1 (``gradients.h:21-32``)."""
    return torch.cat([f[..., :, 1:2] - f[..., :, 0:1], (f[..., :, 2:] - f[..., :, :-2]) * 0.5,
                      f[..., :, -1:] - f[..., :, -2:-1]], dim=-1)


def derivatives(iref: torch.Tensor, imov_w: torch.Tensor, store: Store) -> torch.Tensor:
    """``[dI/dx, dI/dy, I - Iref]`` of the warped moving image
    (``IterativeSolver.cpp:22-56``)."""
    return store(torch.stack([partial_x(imov_w), partial_y(imov_w), imov_w - iref]))


def magnitude_sum(v: torch.Tensor) -> float:
    """Sum of per-pixel magnitudes (``Motion.cpp:42-49`` without the
    1/N), as float32."""
    return np.float32(torch.sqrt(v[0] * v[0] + v[1] * v[1]).sum().item())


def logger_solve(est: torch.Tensor, step, niter: int, tol, store: Store):
    """Iterate ``est <- step(est)`` up to ``niter`` times; stop after
    iteration ``t`` (counted from 0) when ``t > 1`` and the Logger's
    ``|u_t - u_{t-1}| / |u_{t-1}| < tol`` (``Logger.cpp:30-60``; mean
    magnitudes, whose 1/N cancel). Returns ``(est, iterations)``."""
    it = 0
    while it < niter:
        new = store(step(est))
        dsum, psum = magnitude_sum(new - est), magnitude_sum(est)
        err = np.float32(0) if psum == 0 else dsum / psum
        est = new
        it += 1
        if err < tol and it > 2:
            break
    return est, it


def register(iref: torch.Tensor, imov: torch.Tensor, settings: dict, solve_level,
             store: Store):
    """The coarse-to-fine loop (``ImageRegistration.cpp:103-151``): each
    level downsampled straight from full resolution, the coarsest level
    started from zero, every other from the finer-grid field downsampled;
    ``solve_level(u, iref, imov, niter, scale) -> (u, [Solve])``.
    Returns ``(motion [2, nx, ny], [Solve, ...])``, coarse to fine."""
    nscales = settings["nscales"]
    dims = pyramid_dims(tuple(iref.shape), nscales)
    irefs = [store(iref)] + [store(downsample(iref, dims[s])) for s in range(1, nscales + 1)]
    imovs = [store(imov)] + [store(downsample(imov, dims[s])) for s in range(1, nscales + 1)]
    zeros = lambda s: torch.zeros((2,) + dims[s], dtype=iref.dtype, device=iref.device)
    u_full = zeros(0)
    solves = []
    for s in range(nscales, -1, -1):
        if s == nscales and s > 0:
            u = zeros(s)
        elif s > 0:
            u = store(downsample_motion(u_full, dims[s]))
        else:
            u = u_full
        u, level = solve_level(u, irefs[s], imovs[s], int(settings["niter"][s]), s)
        solves.extend(level)
        u_full = store(upsample_motion(u, dims[0])) if s > 0 else u
    return u_full, solves
