"""Plain reference of viscous-fluid registration (Christensen's model), in
float32 PyTorch: the level loop of ``ImageRegistrationFluid.cpp:67-142``
over the steps of ``OpticalFlowFluid.cpp:7-140``.

One iteration at the level's motion ``u``, velocity ``v`` and the
derivatives ``g = [dI/dx, dI/dy, I - Iref]`` of the warped moving image:

1. the force ``f = grad I (It + u . grad I)`` (``OpticalFlow.cpp:15-39``);
2. one SOR sweep of the Navier-Lame stencil on ``v`` with right-hand side
   ``f`` (``OpticalFlowFluid.cpp:7-41``, the stencil of
   ``OpticalFlowElastic.cpp:21-55`` with its y-component reading the
   x-direction neighbours, ``:46-49``), interior points only;
3. the material derivative ``R_c = v_c - (du_c/dx) v_x - (du_c/dy) v_y``
   (``:60-90``);
4. ``dt = 0.65 / max|R|`` (``:92-95``, ``dumax`` of ``OpticalFlowFluid.h:
   32``); the Euler update ``u <- u + R dt`` (``:97-121``) is skipped when
   ``dt >= 65`` (``:135-137``).

The level loop (``ImageRegistrationFluid.cpp:94-125``) logs each step with
the Logger (``Logger.cpp:30-60``: mean magnitudes of the step and of the
previous estimate, stop after the third iteration once their ratio is
below 1e-3), and where it does not stop and ``min det(I + grad u_est)``
(``Image.cpp:189-218``) is below 0.5 it regrids: ``u_est`` is composed into
the level's motion, reset to zero, and the moving image warped and derived
again; the Logger's previous estimate survives the regrid. The velocity
starts at zero on every level and persists across its refinements and
regrids. Each level is downsampled straight from full resolution, and its
motion brought back to full resolution after its solve
(``ImageRegistration.cpp:103-151``).

Departures from the upstream sources, both the program's documented
defaults: the sweep is red-black where the upstream one is lexicographic
(each half-sweep computes every candidate of its colour from the field as
it stood, both components together, then the colour's cells take theirs);
the SOR coefficients are folded into ``1 - omega`` and ``omega / (-6 mu -
2 lambda)``, each rounded once to float32 from its double value. Past an
extent of 4096 the pyramid adds its patches in the order the program
documents there (``opticalflow2d_tpu_torch/ops/resample.py``), written out
here on its own. Where a whole plane of gather indices would not fit beside
the benchmark's pool, the bilinear gathers run a block of rows at a time;
each pixel is computed alike either way.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from torch_bench.reference import common

DUMAX = 0.65            # OpticalFlowFluid.h:32
TIMESTEP_SKIP = 65.0    # OpticalFlowFluid.cpp:135-137
REGRID_THRESHOLD = 0.5  # ImageRegistrationFluid.cpp:108
OMEGA = 0.66            # OpticalFlowFluid.h:10
BLOCK_PIXELS = 1 << 24  # pixels of one block of rows in the gathers


def _row_blocks(start: int, stop: int, ny: int):
    """Rows ``start .. stop`` in blocks of at most ``BLOCK_PIXELS`` pixels."""
    step = max(1, BLOCK_PIXELS // ny)
    return [(r, min(r + step, stop)) for r in range(start, stop, step)]


def _accumulate(terms, n: int):
    """``terms`` added into ``n`` partial sums, term ``k`` into sum ``k mod
    n``, each a running sum; then the sums added pairwise, neighbours
    first."""
    sums = []
    for r in range(min(n, len(terms))):
        total = terms[r]
        for t in terms[r + n::n]:
            total = total + t
        sums.append(total)
    while len(sums) > 1:
        sums = [sums[i] + sums[i + 1] if i + 1 < len(sums) else sums[i]
                for i in range(0, len(sums), 2)]
    return sums[0]


def accumulators(shape, ny_out: int):
    """The partial sums of the x offsets and of the y offsets of a
    downsample past 4096 for an input of ``shape [..., nx, ny]``: y,
    ``64 // ny_out`` clamped to 1-4; x, for an image ``64 // ny`` clamped
    to 1-4, for a stack of planes 4 up to ``nx`` 8224 and 1 above."""
    nx, ny = shape[-2], shape[-1]
    y = min(4, max(1, 64 // ny_out))
    if len(shape) == 2:
        return min(4, max(1, 64 // ny)), y
    return (4 if nx <= 8224 else 1), y


def downsample(image: torch.Tensor, dimout) -> torch.Tensor:
    """Mean over ``fx x fy`` patches anchored at ``(i fx, j fy)``
    (``Field.tpp:76-143``). Up to 4096 in both extents, ``common.downsample``;
    past it, each x offset scaled by ``1 / fx`` and added into the x partial
    sums, then each such column scaled by ``1 / fy`` and added into the y
    partial sums (``accumulators``). Scaling by a power of two is exact, so
    only the order of the adds differs from the mean."""
    nx, ny = image.shape[-2:]
    if nx <= 4096 and ny <= 4096:
        return common.downsample(image, dimout)
    fx, fy = nx // dimout[0], ny // dimout[1]
    crop = image[..., :dimout[0] * fx, :dimout[1] * fy]
    n_x, n_y = accumulators(image.shape, dimout[1])
    cols = [_accumulate([crop[..., a::fx, b::fy] * (1.0 / fx) for a in range(fx)], n_x)
            for b in range(fy)]
    return _accumulate([c * (1.0 / fy) for c in cols], n_y)


def downsample_motion(u: torch.Tensor, dimout) -> torch.Tensor:
    """``Motion.cpp:87-111``: the components scaled by the size ratio."""
    return downsample(u, dimout) * common._ratio(u, dimout)


def _coords(u: torch.Tensor, r0: int, r1: int):
    ny = u.shape[-1]
    gi = torch.arange(r0, r1, dtype=u.dtype, device=u.device)[:, None]
    gj = torch.arange(ny, dtype=u.dtype, device=u.device)[None, :]
    return gi + u[0, r0:r1], gj + u[1, r0:r1]


def warp(image: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """``common.warp`` by blocks of rows."""
    out = torch.empty_like(image)
    for r0, r1 in _row_blocks(0, *image.shape):
        value, weight, inside = common.bilinear(image[None], *_coords(u, r0, r1))
        ok = inside & (weight != 0)
        out[r0:r1] = torch.where(ok, value[0] / torch.where(weight != 0, weight, 1.0),
                                 image[r0:r1])
    return out


def compose(total: torch.Tensor, inc: torch.Tensor) -> torch.Tensor:
    """``common.compose`` by blocks of rows: ``inc + total(x + inc)``."""
    out = torch.empty_like(total)
    for r0, r1 in _row_blocks(0, *total.shape[-2:]):
        value, weight, inside = common.bilinear(total, *_coords(inc, r0, r1))
        warped = value / torch.where(weight != 0, weight, 1.0)
        out[:, r0:r1] = torch.where(inside[None], inc[:, r0:r1]
                                    + torch.where(weight != 0, warped, 0.0), total[:, r0:r1])
    return out


def upsample_motion(u: torch.Tensor, dimout) -> torch.Tensor:
    """``common.upsample_motion`` by blocks of output rows."""
    nx, ny = u.shape[-2:]
    kw = dict(dtype=u.dtype, device=u.device)
    rx, ry = torch.tensor(nx / dimout[0], **kw), torch.tensor(ny / dimout[1], **kw)
    ratio = common._ratio(u, dimout)
    out = torch.empty((2,) + tuple(dimout), **kw)
    py = torch.arange(dimout[1], **kw)[None, :] * ry
    for r0, r1 in _row_blocks(0, *dimout):
        px = torch.arange(r0, r1, **kw)[:, None] * rx
        value, weight, _ = common.bilinear(u, *torch.broadcast_tensors(px, py))
        out[:, r0:r1] = value / torch.where(weight != 0, weight, 1.0) * ratio
    return out


def coefficients(mu: float, lam: float, omega: float):
    """``mu``, ``mu + lambda``, ``1 - omega`` and ``omega / (-6 mu - 2
    lambda)``, each rounded to float32 once."""
    return tuple(common.f32(x) for x in (mu, mu + lam, 1.0 - omega,
                                          omega / (-6.0 * mu - 2.0 * lam)))


def force(g: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """``grad I (It + u_x dI/dx + u_y dI/dy)`` (``OpticalFlow.cpp:15-39``)."""
    inner = g[2] + u[0] * g[0] + u[1] * g[1]
    return g[:2] * inner


def _candidates(x: torch.Tensor, b: torch.Tensor, r0: int, r1: int, coef):
    """The SOR update of both components at interior rows ``r0 .. r1`` and
    interior columns, from the field ``x`` as it stands: ``(1 - omega) x +
    omega / diag (b - mu lap4 - (mu + lambda)(x-direction pair + cross))``
    (``OpticalFlowFluid.cpp:7-41``)."""
    mu, mpl, omw, inv_diag = coef
    out = []
    for c in (0, 1):
        xc, xo = x[c], x[1 - c]
        xp, xm = xc[r0 + 1:r1 + 1, 1:-1], xc[r0 - 1:r1 - 1, 1:-1]
        yp, ym = xc[r0:r1, 2:], xc[r0:r1, :-2]
        lap4 = xp + xm + yp + ym
        cross = 0.25 * (xo[r0 + 1:r1 + 1, 2:] - xo[r0 - 1:r1 - 1, 2:] - xo[r0 + 1:r1 + 1, :-2]
                        + xo[r0 - 1:r1 - 1, :-2])
        num = b[c, r0:r1, 1:-1] - mu * lap4 - mpl * (xp + xm + cross)
        out.append(omw * xc[r0:r1, 1:-1] + inv_diag * num)
    return torch.stack(out)


def sor_sweep(x: torch.Tensor, b: torch.Tensor, coef) -> torch.Tensor:
    """One red-black sweep on the interior: the cells with ``i + j`` even,
    then the odd ones."""
    nx, ny = x.shape[-2:]
    for parity in (0, 1):
        new = x.clone()
        for r0, r1 in _row_blocks(1, nx - 1, ny):
            i = torch.arange(r0, r1, device=x.device)[:, None]
            j = torch.arange(1, ny - 1, device=x.device)[None, :]
            colour = (i + j) % 2 == parity
            new[:, r0:r1, 1:-1] = torch.where(colour, _candidates(x, b, r0, r1, coef),
                                              x[:, r0:r1, 1:-1])
        x = new
    return x


def material_derivative(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``R = v - (du/dx) v_x - (du/dy) v_y`` (``OpticalFlowFluid.cpp:60-90``)."""
    return v - common.partial_x(u) * v[0:1] - common.partial_y(u) * v[1:2]


def timestep(r: torch.Tensor) -> float:
    """``dumax / max|R|`` in float32, ``max|R|`` the square root of the
    largest squared magnitude (``OpticalFlowFluid.cpp:92-95``); infinite
    for ``R == 0``."""
    maxsq = float((r[0] * r[0] + r[1] * r[1]).max())
    if maxsq == 0:
        return math.inf
    return float(np.float32(DUMAX) / np.float32(math.sqrt(maxsq)))


def min_jacobian(u: torch.Tensor) -> float:
    """``min det(I + grad u)`` (``Image.cpp:189-218``)."""
    ux, uy = u[0], u[1]
    det = ((1.0 + common.partial_x(ux)) * (1.0 + common.partial_y(uy))
           - common.partial_x(uy) * common.partial_y(ux))
    return float(det.min())


def solve_level(u, iref, imov, niter: int, scale: int, settings: dict, store):
    """The refinements of one level (``ImageRegistrationFluid.cpp:67-142``),
    the velocity starting at zero. Returns ``(u, [Solve, ...])``."""
    p = settings["regparams"]
    coef = coefficients(p[0], p[1], p[2] if len(p) > 2 else OMEGA)
    tol = np.float32(settings.get("convergence_tol", 0.001))
    n_pix = np.float32(u.shape[-2] * u.shape[-1])
    velocity = torch.zeros_like(u)
    solves = []
    for _ in range(settings["nrefine"]):
        g = common.derivatives(iref, warp(imov, u), store)
        est = torch.zeros_like(u)
        prev = est
        it, regrids, conv = 0, 0, False
        while it < niter and not conv:
            velocity = store(sor_sweep(velocity, force(g, est), coef))
            r = material_derivative(est, velocity)
            dt = timestep(r)
            new = store(est + r * dt) if dt < TIMESTEP_SKIP else est
            del r  # 2 GiB at 16384^2, freed before the sums' temporaries
            dn = common.magnitude_sum(new - prev) / n_pix
            pn = common.magnitude_sum(prev) / n_pix
            err = np.float32(0) if pn == 0 else dn / pn
            conv = bool(err < tol) and it > 1
            prev = new
            if not conv and min_jacobian(new) < REGRID_THRESHOLD:
                u = store(compose(u, new))
                g = common.derivatives(iref, warp(imov, u), store)
                new = torch.zeros_like(new)
                regrids += 1
            est = new
            it += 1
        u = store(compose(u, est))
        solves.append(common.Solve(scale, it, regrids))
    return u, solves


def register(iref, imov, settings: dict, store=lambda x: x):
    """``(motion [2, nx, ny], [Solve, ...])`` of one pair, coarse to fine."""
    nscales = settings["nscales"]
    dims = common.pyramid_dims(tuple(iref.shape), nscales)
    zeros = lambda s: torch.zeros((2,) + dims[s], dtype=iref.dtype, device=iref.device)
    u_full = zeros(0)
    solves = []
    for s in range(nscales, -1, -1):
        iref_s = store(downsample(iref, dims[s])) if s else iref
        imov_s = store(downsample(imov, dims[s])) if s else imov
        if s == nscales and s > 0:
            u = zeros(s)
        elif s > 0:
            u = store(downsample_motion(u_full, dims[s]))
        else:
            u = u_full
        u, level = solve_level(u, iref_s, imov_s, int(settings["niter"][s]), s, settings,
                               store)
        solves.extend(level)
        del iref_s, imov_s
        u_full = store(upsample_motion(u, dims[0])) if s else u
    return u_full, solves
