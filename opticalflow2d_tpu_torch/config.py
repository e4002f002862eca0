"""Typed configuration for the registration engine (PyTorch port).

Same fields, defaults and regparam packing as ``opticalflow2d_tpu.config``
(the reference's positional MEX surface, ``WrapperOpticalFlow2d.cpp:23-83``),
minus the knobs that only existed for the TPU: ``use_pallas`` (on CUDA the
kernels always run), ``warp_halo``/``warp_halo_outer``/``warp_halo_auto``
(the CUDA gather is exact for any displacement) and the elastic tiling
knobs ``pallas_block_elastic``/``pallas_block_k_elastic`` (the elastic
driver blocks at every level with ``min(4, block_k)`` iterations a pass).
``pallas_block_k`` keeps its meaning as ``block_k``. ``dct_impl`` takes the
port's own values, ``"auto"``, ``"matmul"`` and ``"fft"``.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Sequence, Tuple

import torch


# The curvature DCT's routes (``RegConfig.dct_impl``).
DCT_IMPLS = ("auto", "matmul", "fft")


class Method(enum.IntEnum):
    """Solver families; values match the reference's ``Regularisation`` enum
    (``src/SolverOptions.h:4``)."""

    DIFFUSION = 0
    CURVATURE = 1
    ELASTIC = 2
    THIRIONS_DEMONS = 3
    DIFFEOMORPHIC_DEMONS = 4
    FLUID = 5


class MotionAccumulation(enum.IntEnum):
    """``src/SolverOptions.h:8``."""

    COMPOSITION = 0
    ADDITION = 1


@dataclasses.dataclass(frozen=True)
class CompatFlags:
    """Bug-compatibility switches for quirks in the reference (SURVEY.md §2.3).
    Defaults are the fixed behaviours; see ``opticalflow2d_tpu.config`` for
    the reference lines each flag reproduces."""

    # Motion::maxabs sums .y twice (reference src/Motion.cpp:54).
    maxabs_bug: bool = False
    # Field::convolute wraps across rows (reference src/Field.tpp:245-246).
    conv_flatwrap: bool = False
    # Elastic/Fluid SOR y-component stencil as the reference writes it
    # (OpticalFlowElastic.cpp:46-49).
    elastic_stencil_reference: bool = True
    # A second session register() continues from the previous call's
    # coarsest-level field, as the persistent MEX object does
    # (ImageRegistration.cpp:137-139, WrapperOpticalFlow2d.cpp:86-102).
    persistent_motion: bool = False


@dataclasses.dataclass(frozen=True)
class RegConfig:
    """Full registration configuration.

    ``niter`` has ``nscales + 1`` entries; ``niter[s]`` is the iteration cap
    at pyramid scale ``s`` (s=0 is full resolution).
    """

    method: Method
    niter: Tuple[int, ...]
    nscales: int = 0
    nrefine: int = 1

    # Variational parameters (reference OpticalFlowDiffusion/Curvature/
    # Elastic/Fluid headers).
    alpha: float = 1.0
    tau: float = 1.0
    mu: float = 1.0
    lam: float = 0.0
    omega: float = 0.66
    dumax: float = 0.65

    # Demons parameters (reference Demons.h:10-13).
    sigma_i: float = 1.0
    sigma_x: float = 0.25
    sigma_diffusion: float = 2.0
    sigma_fluid: float = 2.0
    kernelwidth: int = 5
    accumulation: MotionAccumulation = MotionAccumulation.COMPOSITION

    # Convergence (reference ImageRegistrationOpticalFlow.cpp:130-134,
    # ImageRegistrationFluid.cpp:108, OpticalFlowFluid.cpp:135-137).
    convergence_tol: float = 0.001
    regrid_threshold: float = 0.5
    timestep_skip: float = 65.0

    # Elastic/fluid solver choices ("redblack"/"lexicographic";
    # "sor"/"spectral"/"spectral_dirichlet").
    sor_ordering: str = "redblack"
    navier_lame_solver: str = "sor"
    dtype: str = "float32"
    compat: CompatFlags = dataclasses.field(default_factory=CompatFlags)
    # Jacobi iterations per memory pass of the blocked diffusion kernel
    # (the elastic kernel takes min(4, block_k)). The Logger stop stays
    # exact: a stop inside a block recomputes that block's taken steps.
    block_k: int = 8
    # Curvature DCT: "matmul" (dense float32 matmuls, bit-closest to the
    # reference), "fft" (the Makhoul factorization, O(n^2 log n) where the
    # matmuls are O(n^3)) or "auto" ("matmul"; see resolved_dct_impl).
    dct_impl: str = "auto"
    # Print every iteration's relative error as the host loop reads it
    # (the reference Logger's verbose mode, src/Logger.cpp:62-79).
    verbose_stream: bool = False

    def __post_init__(self):
        if len(self.niter) < self.nscales + 1:
            raise ValueError(
                f"niter needs at least nscales+1={self.nscales + 1} entries, "
                f"got {len(self.niter)}"
            )
        if self.nscales < 0:
            raise ValueError("nscales must be >= 0")
        if self.nrefine < 1:
            raise ValueError("nrefine must be >= 1")
        if self.kernelwidth < 1 or self.kernelwidth % 2 == 0:
            raise ValueError("kernelwidth must be odd and >= 1")
        if self.block_k < 1:
            raise ValueError("block_k must be >= 1")
        if self.dct_impl not in DCT_IMPLS:
            raise ValueError(f"dct_impl must be one of {DCT_IMPLS}, got {self.dct_impl!r}")

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def resolved_dct_impl(self) -> str:
        """Resolve ``dct_impl="auto"``. The JAX package gives the bug-compat
        configs the bit-closest dense transform and the others its fastest
        accurate one, which here would be ``"fft"``; but the fft route's
        512^2 curvature registration ends 1.08e-5 px from the matmul
        route's on an H100, past the 1e-5 gate that admits it as the
        default (ROADMAP queue C), so ``"auto"`` is ``"matmul"`` for every
        config. ``"fft"`` stays a choice."""
        return "matmul" if self.dct_impl == "auto" else self.dct_impl

    @staticmethod
    def from_regparams(
        method: Method | int,
        niter: Sequence[int],
        nscales: int,
        regparams: Sequence[float],
        nrefine: int = 1,
        **overrides,
    ) -> "RegConfig":
        """Build a config from the reference's positional regparam packing
        (validation as ``valid_regularisation_parameters``, reference
        ImageRegistrationOpticalFlow.cpp:8-12, ImageRegistrationDemons.cpp:
        7-10, ImageRegistrationFluid.cpp:5-7)."""
        method = Method(method)
        p = [float(v) for v in regparams]
        n = len(p)
        kw = dict(
            method=method,
            niter=tuple(int(v) for v in niter),
            nscales=int(nscales),
            nrefine=int(nrefine),
        )
        if method == Method.DIFFUSION:
            if n != 1:
                raise ValueError("Diffusion takes exactly 1 regparam [alpha]")
            kw["alpha"] = p[0]
        elif method == Method.CURVATURE:
            if not 1 <= n <= 2:
                raise ValueError("Curvature takes 1-2 regparams [alpha(, tau)]")
            kw["alpha"] = p[0]
            if n == 2:
                kw["tau"] = p[1]
        elif method in (Method.ELASTIC, Method.FLUID):
            if not 2 <= n <= 3:
                raise ValueError(
                    f"{method.name} takes 2-3 regparams [mu, lambda(, omega)]"
                )
            kw["mu"], kw["lam"] = p[0], p[1]
            if n == 3:
                kw["omega"] = p[2]
        elif method == Method.THIRIONS_DEMONS:
            if n != 6:
                raise ValueError(
                    "ThirionsDemons takes exactly 6 regparams "
                    "[sigma_i, sigma_x, sigma_diff, sigma_fluid, kernelwidth, accum]"
                )
            kw.update(
                sigma_i=p[0], sigma_x=p[1], sigma_diffusion=p[2],
                sigma_fluid=p[3],
                # truncated from float, as the reference does
                # (ImageRegistrationDemons.cpp:26)
                kernelwidth=int(p[4]),
                accumulation=MotionAccumulation(int(p[5])),
            )
        elif method == Method.DIFFEOMORPHIC_DEMONS:
            if n != 5:
                raise ValueError(
                    "DiffeomorphicDemons takes exactly 5 regparams "
                    "[sigma_i, sigma_x, sigma_diff, sigma_fluid, kernelwidth]"
                )
            kw.update(
                sigma_i=p[0], sigma_x=p[1], sigma_diffusion=p[2],
                sigma_fluid=p[3], kernelwidth=int(p[4]),
            )
        kw.update(overrides)
        return RegConfig(**kw)
