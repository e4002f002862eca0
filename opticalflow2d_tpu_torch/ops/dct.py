"""2D DCT-II/DCT-III in FFTW's r2r conventions, by dense matmuls or by the
Makhoul FFT factorization, and the curvature operator's eigenvalues
(PyTorch port of ``opticalflow2d_tpu.ops.dct``).

The reference runs FFTW REDFT10 (forward) / REDFT01 (inverse) plans per
component and divides by ``4 * N`` afterwards (``src/regularization/
OpticalFlow/OpticalFlowCurvature.cpp:52-55, 99-167``). Conventions
(unnormalized, as FFTW's):

- REDFT10: ``Y[k] = 2 * sum_n X[n] cos(pi (n+1/2) k / N)``
- REDFT01: ``Y[k] = X[0] + 2 * sum_{n>=1} X[n] cos(pi n (k+1/2) / N)``

so REDFT01(REDFT10(x)) = 2N * x per axis; the caller (the curvature
solver) applies the ``1/(4 nx ny)``.

The matmul route is ``C2x @ A @ C2y^T`` (cuBLAS on the GPU). Its matrices
are built in float64 on the host at every extent, cast to float32 and
cached per ``(n, kind, device)``. Below 2048 that is the JAX package's
host table bit for bit; from 2048 up JAX generates the matrix on the
device in float32 (a limit of its compile requests), a few ulp from the
float64 table: at 2048 the two differ by up to 7.7e-7 an entry, 3.25 ulp
of the entries' scale 2. The FFT route (cuFFT) is O(n^2 log n) where the matmuls are
O(n^3), and keeps JAX's dtypes: a float32 phase, complex64 products.

Every matmul here runs at full float32: ``full_f32`` turns TF32 off for
the call, whatever the caller set, and restores the caller's setting.
"""

from __future__ import annotations

import contextlib
import functools

import numpy as np
import torch

# Below this extent the eigenvalue table is the reference's float64
# expression, from it a float32 outer sum (JAX's _DEVICE_GEN_MIN).
_F64_TABLE_MAX = 2048


@contextlib.contextmanager
def full_f32():
    """cuBLAS float32 matmuls without TF32 inside the block; the caller's
    setting, by whichever of PyTorch's two APIs it was made, is restored
    after it."""
    m = torch.backends.cuda.matmul
    new_api = getattr(m, "fp32_precision", None)
    try:
        legacy = torch.get_float32_matmul_precision()
    except RuntimeError:  # the caller set TF32 through the newer API only
        legacy = None
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        if legacy is None:
            m.fp32_precision = new_api
        else:
            torch.set_float32_matmul_precision(legacy)
            if new_api == "none":  # inherited, as before the block
                m.fp32_precision = new_api


def _dct2_matrix(n: int) -> np.ndarray:
    """REDFT10 (DCT-II) matrix, float64."""
    k = np.arange(n)[:, None]
    j = np.arange(n)[None, :]
    return 2.0 * np.cos(np.pi * (j + 0.5) * k / n)


def _dct3_matrix(n: int) -> np.ndarray:
    """REDFT01 (DCT-III) matrix, float64."""
    k = np.arange(n)[:, None]
    j = np.arange(n)[None, :]
    m = 2.0 * np.cos(np.pi * j * (k + 0.5) / n)
    m[:, 0] = 1.0
    return m


_TABLES = {2: _dct2_matrix, 3: _dct3_matrix}


@functools.lru_cache(maxsize=16)
def _dct_matrix_cached(n: int, kind: int, device: str) -> torch.Tensor:
    return torch.from_numpy(_TABLES[kind](n).astype(np.float32)).to(device)


def dct_matrix(n: int, kind: int, device) -> torch.Tensor:
    """The ``[n, n]`` float32 REDFT10 (``kind=2``) or REDFT01 (``kind=3``)
    matrix on ``device``."""
    return _dct_matrix_cached(int(n), int(kind), str(torch.device(device)))


def _dense(a: torch.Tensor, kind: int) -> torch.Tensor:
    nx, ny = a.shape[-2], a.shape[-1]
    cx = dct_matrix(nx, kind, a.device)
    cy = dct_matrix(ny, kind, a.device)
    with full_f32():
        return torch.matmul(torch.matmul(cx, a), cy.T)


def dct2_fftw(a: torch.Tensor) -> torch.Tensor:
    """2D DCT-II (FFTW REDFT10 x REDFT10) over the trailing two axes."""
    return _dense(a, 2)


def idct2_fftw(a: torch.Tensor) -> torch.Tensor:
    """2D DCT-III (FFTW REDFT01 x REDFT01) over the trailing two axes.
    ``idct2_fftw(dct2_fftw(x)) == 4 * nx * ny * x``."""
    return _dense(a, 3)


@functools.lru_cache(maxsize=32)
def _twiddle_cached(n: int, sign: float, device: str) -> torch.Tensor:
    k = torch.arange(n, dtype=torch.float32)
    phase = ((k * float(np.float32(sign * np.pi))) / float(2 * n)).double()
    tw = torch.complex(torch.cos(phase).float(), torch.sin(phase).float())
    return tw.to(device)


def _twiddle(n: int, sign: float, device) -> torch.Tensor:
    """``exp(sign * 1j * pi * k / (2n))`` as JAX forms it from an int32 ``k``
    and Python scalars: a float32 phase ``(pi * k) / (2n)`` (JAX's bits),
    complex64. Its cosine and sine are taken in float64 on the host and
    rounded once, so that every device holds the same twiddles."""
    return _twiddle_cached(int(n), float(sign), str(torch.device(device)))


def _dct1d_fft(x: torch.Tensor, axis: int, inverse: bool = False) -> torch.Tensor:
    """1D REDFT10/REDFT01 along ``axis`` by the Makhoul FFT factorization."""
    n = x.shape[axis]
    x = torch.movedim(x, axis, -1)
    if not inverse:
        # Even-odd reorder, complex FFT, half-sample phase twiddle.
        v = torch.cat([x[..., 0::2], x[..., 1::2].flip(-1)], dim=-1)
        vf = torch.fft.fft(v)
        out = 2.0 * torch.real(_twiddle(n, -1.0, x.device) * vf)
    else:
        k = torch.arange(n, device=x.device)
        xe = torch.cat([x, torch.zeros_like(x[..., :1])], dim=-1)
        u_spec = (xe[..., :n] - 1j * xe[..., n - k]) * _twiddle(n, 1.0, x.device)
        u = torch.fft.ifft(u_spec) * n
        half = (n + 1) // 2
        out = torch.empty_like(x)
        out[..., 0::2] = torch.real(u[..., :half])
        out[..., 1::2] = torch.real(u[..., half:].flip(-1))
    return torch.movedim(out.to(x.dtype), -1, axis).contiguous()


def dct2_fft(a: torch.Tensor) -> torch.Tensor:
    """2D DCT-II (FFTW REDFT10 x2) by FFT over the trailing two axes."""
    return _dct1d_fft(_dct1d_fft(a, -1), -2)


def idct2_fft(a: torch.Tensor) -> torch.Tensor:
    """2D DCT-III (FFTW REDFT01 x2) by FFT over the trailing two axes."""
    return _dct1d_fft(_dct1d_fft(a, -1, inverse=True), -2, inverse=True)


def curvature_eigenvalues(nx: int, ny: int, alpha: float, tau: float,
                          device="cpu", dtype=torch.float32) -> torch.Tensor:
    """Inverse eigenvalues of the semi-implicit biharmonic update in the DCT
    basis, ``1 / (1 + tau * alpha * (-4 + 2 cos(p pi / nx) + 2 cos(q pi /
    ny))^2)`` (reference ``OpticalFlowCurvature.cpp:6-30``, with its PI of
    3.14159265), ``[nx, ny]`` on ``device``.

    Below an extent of 2048 the table is the reference's float64 expression,
    cast once; from 2048 up it is a float32 outer sum of the 1D cosine
    tables and the rest in float32, as the JAX package assembles it there,
    so both branches equal JAX's bit for bit."""
    PI = 3.14159265
    cx = 2.0 * np.cos(np.arange(nx, dtype=np.float64) * PI / nx)
    cy = 2.0 * np.cos(np.arange(ny, dtype=np.float64) * PI / ny)
    if max(nx, ny) >= _F64_TABLE_MAX:
        lx = torch.from_numpy(cx - 4.0).to(device=device, dtype=dtype)
        ly = torch.from_numpy(cy).to(device=device, dtype=dtype)
        lam = lx[:, None] + ly[None, :]
        ta = torch.tensor(tau * alpha, dtype=dtype, device=device)
        return 1.0 / (1.0 + ta * lam * lam)
    eig = 1.0 / (1.0 + tau * alpha * (-4.0 + cx[:, None] + cy[None, :]) ** 2)
    return torch.from_numpy(eig).to(device=device, dtype=dtype)
