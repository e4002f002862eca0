"""Stateful session API mirroring the reference MEX wrapper's 5-command
surface (``WrapperOpticalFlow2d.cpp:18-155``), the PyTorch port of
``opticalflow2d_tpu.engine.session``:

    OpticalFlow2d([dimx dimy], niter, nscales, reg, regparams, nparams,
                  nrefine, verbose)                       -> __init__
    OpticalFlow2d(Iref, Imov)                             -> register()
    motion = OpticalFlow2d()                              -> get_motion()
    Ireg = OpticalFlow2d(Imov)                            -> warp(Imov)
    OpticalFlow2d() [close]                               -> close()
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from opticalflow2d_tpu_torch.config import Method, RegConfig
from opticalflow2d_tpu_torch.engine import registration
from opticalflow2d_tpu_torch.engine.registration import (
    RegistrationResult,
    register,
    register_phased,
    resolve_device,
)
from opticalflow2d_tpu_torch.ops.warp import warp2d


class OpticalFlow2d:
    """Session object holding the last estimated motion field.

    Images are ``[nx, ny]`` (axis 0 is the reference's "x"). ``device`` is
    where the session registers: ``None`` means CUDA (and raises on a host
    without it), ``"cpu"`` the CPU; images, arrays or tensors, are moved
    there. ``get_motion()`` returns ``[nx, ny, 2]``, the MEX readback layout
    (``WrapperOpticalFlow2d.cpp:105-117``). Demons takes the reference's
    regparams ``[sigma_i, sigma_x, sigma_diff, sigma_fluid, kernelwidth,
    accumulation]`` (Thirion) or the first five (diffeomorphic); elastic
    and fluid ``[mu, lambda(, omega)]``.
    """

    def __init__(
        self,
        dims: Sequence[int],
        niter: Sequence[int],
        nscales: int,
        regularisation: Method | int,
        regparams: Sequence[float],
        nrefine: int = 1,
        verbose: bool = False,
        device: torch.device | str | None = None,
        **config_overrides,
    ):
        self.dims = (int(dims[0]), int(dims[1]))
        config_overrides.setdefault("verbose_stream", bool(verbose))
        self.config = RegConfig.from_regparams(
            regularisation, niter, nscales, regparams, nrefine, **config_overrides
        )
        self.device = resolve_device(device)
        self.verbose = verbose
        self._result: Optional[RegistrationResult] = None
        if verbose:
            print(self._banner())

    def _banner(self) -> str:
        """Parameter banner, the analogue of
        ``ImageRegistration::display_registration_parameters``
        (``ImageRegistration.cpp:6-47``)."""
        c = self.config
        lines = [
            "=" * 72,
            "Optical flow image registration (PyTorch implementation)",
            f"dimensions:      {self.dims}",
            f"niter:           {c.niter[: c.nscales + 1]}",
            f"nscales:         {c.nscales}",
            f"nrefine:         {c.nrefine}",
            f"regularisation:  {c.method.name}",
        ]
        if c.method == Method.DIFFUSION:
            lines.append(f"alpha:           {c.alpha}")
        elif c.method == Method.CURVATURE:
            lines.append(f"alpha:           {c.alpha}")
            lines.append(f"tau:             {c.tau}")
        elif c.method in (Method.ELASTIC, Method.FLUID):
            lines.append(f"mu:              {c.mu}")
            lines.append(f"lambda:          {c.lam}")
            lines.append(f"omega (SOR):     {c.omega}")
        else:  # demons families
            lines.append(f"sigma_i:         {c.sigma_i}")
            lines.append(f"sigma_x:         {c.sigma_x}")
            lines.append(f"sigma_diffusion: {c.sigma_diffusion}")
            lines.append(f"sigma_fluid:     {c.sigma_fluid}")
            lines.append(f"kernelwidth:     {c.kernelwidth}")
            if c.method == Method.THIRIONS_DEMONS:
                lines.append(f"accumulation:    {c.accumulation.name}")
        lines.append("=" * 72)
        return "\n".join(lines)

    def register(self, iref, imov) -> RegistrationResult:
        """Run the registration; the motion is kept for get_motion()/warp().

        With ``CompatFlags.persistent_motion`` a second call continues from
        the previous one's coarsest-level field, as the reference's
        persistent MEX object does (ImageRegistration.cpp:137-139)."""
        if tuple(iref.shape) != self.dims:
            raise ValueError(f"expected images of shape {self.dims}, got {tuple(iref.shape)}")
        warm_coarse = None
        if (self.config.compat.persistent_motion and self._result is not None
                and self._result.coarse_motion is not None):
            warm_coarse = self._result.coarse_motion
        # A grid past 8192 goes to register_phased, as in the JAX session
        # (opticalflow2d_tpu/engine/session.py:113-124). The extent is read
        # through the module, so the level route and this one share it.
        huge = max(self.dims) > registration._DERIV_BARRIER_MIN_EXTENT
        run = register_phased if huge else register
        self._result = run(iref, imov, self.config, initial_coarse_motion=warm_coarse,
                           device=self.device)
        if self.verbose:
            for t in self._result.traces:
                n = t.iterations
                last = float(t.errors[n - 1]) if n else 0.0
                print(f"scale {t.scale}: {n} iterations, "
                      f"final rel-err {last:.4f}, regrids {t.regrids}")
        return self._result

    @property
    def result(self) -> Optional[RegistrationResult]:
        return self._result

    def get_motion(self) -> torch.Tensor:
        """The estimated motion as ``[nx, ny, 2]`` (x-plane first)."""
        if self._result is None:
            raise RuntimeError("no registration has been run")
        return self._result.motion.movedim(0, -1)

    def warp(self, image) -> torch.Tensor:
        """Warp an image with the stored motion field
        (``WrapperOpticalFlow2d.cpp:120-137``)."""
        if self._result is None:
            raise RuntimeError("no registration has been run")
        motion = self._result.motion
        return warp2d(torch.as_tensor(image, dtype=motion.dtype, device=motion.device),
                      motion)

    def close(self):
        """Drop the stored state (the MEX 'close' command)."""
        self._result = None
