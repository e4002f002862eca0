"""Thirion and diffeomorphic demons solvers (PyTorch port of
``opticalflow2d_tpu.solvers.demons``).

Per iteration (reference ``src/regularization/Demons/DemonsThirions.cpp:18-42``
and ``DemonsDiffeomorphic.cpp:15-35``):
  1. warp the refinement-warped moving image by the current motion estimate,
  2. derivatives of the warped image,
  3. demons correspondence force,
  4. Gaussian-smooth the correspondence ("fluid" smoothing),
  5. Thirion: compose or add it into the motion (``MotionAccumulation``);
     diffeomorphic: exponentiate it (scaling and squaring), then compose,
  6. Gaussian-smooth the motion ("diffusion" smoothing).

The route is chosen from the configuration alone, before any launch:

- ``"op_chain"``: ``conv_flatwrap``, or a kernelwidth whose tile does not
  fit the kernels' shared memory. The steps above as plain ops, with the
  warp, the compositions and the Logger sums on their kernels (B3, B4).
- ``"onepass"``: Thirion, and diffeomorphic where the exp map is the
  identity. One kernel (B10) per iteration, with its Logger sums.
- ``"two_kernel"``: diffeomorphic otherwise. B11, the exp map on B3, B12,
  then B4 for the Logger sums.

On the CPU every kernel runs its plain version, along the same route.
``make_demons_batch_step`` is the ``"onepass"`` route on the listed pairs
of a stack (B10's pair axis), for the lockstep demons driver; the other two
routes have no pair axis.
"""

from __future__ import annotations

import torch

from opticalflow2d_tpu_torch.config import MotionAccumulation
from opticalflow2d_tpu_torch.kernels.demons_fused import compose_smooth, demons_correspondence
from opticalflow2d_tpu_torch.kernels.demons_onepass import (
    thirion_onepass,
    thirion_onepass_batch,
    tile_fits,
)
from opticalflow2d_tpu_torch.kernels.logger_norms import logger_norms
from opticalflow2d_tpu_torch.ops.conv import gaussian_smooth
from opticalflow2d_tpu_torch.ops.warp import compose, expmap, static_expmap_nsq, warp2d
from opticalflow2d_tpu_torch.solvers.base import demons_force, derivatives


def logger_sums(u_new: torch.Tensor, u_prev: torch.Tensor) -> torch.Tensor:
    """Logger pair ``[sum |u_new - u_prev|, sum |u_prev|]`` (pixel
    magnitudes; reference src/Logger.cpp:30-60 tracks their ratio /N /N),
    by the norm kernel on CUDA."""
    return logger_norms(u_new, u_prev)


def expmap_identity_regime(sigma_i: float, sigma_x: float,
                           maxabs_bug: bool = False) -> bool:
    """True when the diffeomorphic exp map is the identity for every
    reachable correspondence: the smoothed force magnitude is bounded by
    ``sigma_x/(2*sigma_i)`` (AM-GM on the force denominator; renormalized
    Gaussian smoothing is a convex combination and keeps the bound), and for
    bounds <= 0.5 the squaring count is 0, the reference's nsquares == 0
    early return (``src/Motion.cpp:257-260``). The diffeomorphic step is
    then exactly the Thirion composition step. The 1.0001 factor guards a
    measured maxabs an ulp past an exactly-0.5 bound; ``maxabs_bug``
    inflates the measured value by up to sqrt(2), so bug-compatible
    configs are excluded."""
    return (not maxabs_bug and sigma_i > 0
            and static_expmap_nsq(sigma_x / (2.0 * sigma_i) * 1.0001) == 0)


def demons_route(sigma_i: float, sigma_x: float, kernelwidth: int, diffeomorphic: bool,
                 conv_flatwrap: bool = False, maxabs_bug: bool = False) -> str:
    """The route ``make_demons_step`` takes for these parameters:
    ``"op_chain"``, ``"onepass"`` or ``"two_kernel"`` (module docstring)."""
    if conv_flatwrap or not tile_fits(kernelwidth):
        return "op_chain"
    if not diffeomorphic or expmap_identity_regime(sigma_i, sigma_x, maxabs_bug):
        return "onepass"
    return "two_kernel"


def make_demons_step(
    sigma_i: float,
    sigma_x: float,
    sigma_diffusion: float,
    sigma_fluid: float,
    kernelwidth: int,
    diffeomorphic: bool,
    accumulation: MotionAccumulation = MotionAccumulation.COMPOSITION,
    conv_flatwrap: bool = False,
    maxabs_bug: bool = False,
    with_errors: bool = False,
):
    """Build the demons step ``(u, iref, imov) -> u`` (or ``-> (u, sums)``
    with ``with_errors``, ``sums = logger_sums(u_new, u)``). ``imov`` is
    the refinement-warped moving image (the reference's ``Iaux``)."""
    route = demons_route(sigma_i, sigma_x, kernelwidth, diffeomorphic, conv_flatwrap,
                         maxabs_bug)
    # Diffeomorphic demons always composes (DemonsDiffeomorphic.cpp:30-33).
    addition = not diffeomorphic and accumulation == MotionAccumulation.ADDITION

    def onepass(u, iref, imov):
        return thirion_onepass(imov, iref, u, sigma_i, sigma_x, sigma_fluid,
                               sigma_diffusion, kernelwidth, addition, with_errors)

    def two_kernel(u, iref, imov):
        c = demons_correspondence(imov, iref, u, sigma_i, sigma_x, sigma_fluid, kernelwidth)
        c = expmap(c, maxabs_bug=maxabs_bug)
        u_new = compose_smooth(u, c, sigma_diffusion, kernelwidth)
        return (u_new, logger_sums(u_new, u)) if with_errors else u_new

    def op_chain(u, iref, imov):
        d = derivatives(iref, warp2d(imov, u))
        c = demons_force(d, sigma_i, sigma_x)
        c = gaussian_smooth(c, sigma_fluid, kernelwidth, flatwrap=conv_flatwrap)
        if diffeomorphic:
            u_new = compose(u, expmap(c, maxabs_bug=maxabs_bug))
        elif addition:
            u_new = u + c
        else:
            u_new = compose(u, c)
        u_new = gaussian_smooth(u_new, sigma_diffusion, kernelwidth, flatwrap=conv_flatwrap)
        return (u_new, logger_sums(u_new, u)) if with_errors else u_new

    return {"onepass": onepass, "two_kernel": two_kernel, "op_chain": op_chain}[route]


def make_demons_batch_step(
    sigma_i: float,
    sigma_x: float,
    sigma_diffusion: float,
    sigma_fluid: float,
    kernelwidth: int,
    diffeomorphic: bool,
    accumulation: MotionAccumulation = MotionAccumulation.COMPOSITION,
    conv_flatwrap: bool = False,
    maxabs_bug: bool = False,
):
    """Build the ``"onepass"`` demons step on the listed pairs of a stack,
    ``(u, irefs, iaux, pairs, out) -> sums``: ``u [B, 2, nx, ny]``,
    ``irefs`` and the refinement-warped moving images ``iaux [B, nx, ny]``,
    ``pairs`` a ``Pairs`` of the stack. It writes each listed pair's new
    motion into ``out[p]``, leaves the other pairs as they are, and returns
    their Logger sums ``[n_pairs, 2]`` in list order: one launch of B10's
    pair axis, so each pair's motion and sums equal ``make_demons_step``'s
    (``with_errors``) bit for bit. Thirion by composition or addition, and
    diffeomorphic in the exp map's identity regime; the other routes raise
    (``demons_route``)."""
    route = demons_route(sigma_i, sigma_x, kernelwidth, diffeomorphic, conv_flatwrap,
                         maxabs_bug)
    if route != "onepass":
        raise ValueError(f"the demons batch step runs the onepass route (B10's pair axis), "
                         f"not {route!r}")
    addition = not diffeomorphic and accumulation == MotionAccumulation.ADDITION

    def step(u: torch.Tensor, irefs: torch.Tensor, iaux: torch.Tensor, pairs,
             out: torch.Tensor) -> torch.Tensor:
        _, sums = thirion_onepass_batch(iaux, irefs, u, sigma_i, sigma_x, sigma_fluid,
                                        sigma_diffusion, kernelwidth, addition, pairs, out)
        return sums

    return step
