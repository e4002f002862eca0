"""Finite differences, reductions, resampling and warps (PyTorch)."""

from opticalflow2d_tpu_torch.ops.boundary import dirichlet_boundary, neumann_boundary
from opticalflow2d_tpu_torch.ops.dct import (
    curvature_eigenvalues,
    dct2_fft,
    dct2_fftw,
    idct2_fft,
    idct2_fftw,
)

__all__ = [
    "dirichlet_boundary", "neumann_boundary",
    "dct2_fftw", "idct2_fftw", "dct2_fft", "idct2_fft", "curvature_eigenvalues",
]
