"""Curvature (biharmonic) solver: semi-implicit time marching solved
spectrally in the DCT basis (PyTorch port of
``opticalflow2d_tpu.solvers.curvature``).

Per iteration (reference ``src/regularization/OpticalFlow/
OpticalFlowCurvature.cpp:144-167``):
  1. force ``f`` at the current motion,
  2. rhs = ``u - tau * f``,
  3. forward DCT-II per component,
  4. multiply by the precomputed inverse eigenvalues of ``(I + tau*alpha*B^2)``,
  5. inverse DCT-III, normalize by ``4*nx*ny``.

No hand-written kernel: the transforms are cuBLAS matmuls (``"matmul"``)
or cuFFT transforms (``"fft"``) at full float32 (``ops.dct``), as the JAX
package computes them outside any Pallas kernel.
"""

from __future__ import annotations

import torch

from opticalflow2d_tpu_torch.config import DCT_IMPLS
from opticalflow2d_tpu_torch.ops.dct import (
    curvature_eigenvalues,
    dct2_fft,
    dct2_fftw,
    full_f32,
    idct2_fft,
    idct2_fftw,
)
from opticalflow2d_tpu_torch.solvers.base import Derivatives, lssd_force

def make_curvature_solve(nx: int, ny: int, alpha: float, tau: float,
                         dtype=torch.float32, dct_impl: str = "auto"):
    """The spectral half of the curvature step: ``rhs -> idct(dct(rhs) *
    eig) / (4 nx ny)``. ``dct_impl``: ``"matmul"``, the dense transform
    (bit-closest to the reference), or ``"fft"``, the Makhoul
    factorization, O(n^2 log n); ``"auto"`` is ``"matmul"``, as
    ``RegConfig.resolved_dct_impl`` says why. The eigenvalue table is built
    on the first call's device and kept for the next calls there."""
    if dct_impl not in DCT_IMPLS:
        raise ValueError(f"unknown dct_impl {dct_impl!r}; expected one of {DCT_IMPLS}")
    fwd, inv = (dct2_fft, idct2_fft) if dct_impl == "fft" else (dct2_fftw, idct2_fftw)
    scale = 1.0 / (4.0 * nx * ny)
    eigs = {}

    def solve(rhs: torch.Tensor) -> torch.Tensor:
        eig = eigs.get(rhs.device)
        if eig is None:
            eig = eigs[rhs.device] = curvature_eigenvalues(nx, ny, alpha, tau, rhs.device, dtype)
        with full_f32():
            spec = fwd(rhs) * eig[None]
            return inv(spec) * scale

    return solve


def make_curvature_step(nx: int, ny: int, alpha: float, tau: float,
                        dtype=torch.float32, dct_impl: str = "auto"):
    """Build the curvature step ``(u [2, nx, ny], d) -> u'`` for a fixed
    level shape: the eigenvalue table is a per-level constant, as the
    reference's per-level FFTW plans are."""
    solve = make_curvature_solve(nx, ny, alpha, tau, dtype, dct_impl)

    def step(u: torch.Tensor, d: Derivatives) -> torch.Tensor:
        f = lssd_force(d, u)
        return solve(u - tau * f)

    return step
