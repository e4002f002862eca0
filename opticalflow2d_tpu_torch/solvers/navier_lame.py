"""Spectral Navier-Lame solvers (PyTorch port of
``opticalflow2d_tpu.solvers.navier_lame``).

The reference relaxes the Navier-Lame system with one SOR sweep an
iteration (``OpticalFlowElastic.cpp:21-55``, ``OpticalFlowFluid.cpp:
7-41``). These solve the same finite-difference system exactly, once an
iteration:

- ``make_spectral_navier_lame_solver``: periodic boundaries, the textbook
  (symmetric) stencil, by ``rfft2``, a 2x2 inverse per frequency and
  ``irfft2`` (cuFFT on the GPU). The symbols are ``dxx = 2cos(wx) - 2``,
  ``dyy = 2cos(wy) - 2`` and ``dxy = -sin(wx) sin(wy)``; the mean mode is
  null and set to zero. ``RegConfig.navier_lame_solver="spectral"``.
- ``make_dirichlet_navier_lame_solver``: the reference's interior-point
  system with homogeneous Dirichlet borders (the fixed point of its SOR
  from a zero iterate), by conjugate gradients preconditioned with the
  DST-I diagonal solve (float32 matmuls on cuBLAS, TF32 off).
  ``RegConfig.navier_lame_solver="spectral_dirichlet"``.

No hand-written kernel: JAX computes these outside any Pallas kernel too.
Its ``precision`` argument (an MXU pass count) is dropped: every matmul
here is full float32.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from opticalflow2d_tpu_torch.ops.dct import full_f32


@functools.lru_cache(maxsize=32)
def _inverse_coeffs(nx: int, ny: int, mu: float, lam: float):
    """NumPy ``[nx, ny//2+1]`` arrays ``(i00, i11, i01)``: the 2x2 inverse
    of the Navier-Lame symbol at each ``rfft2`` frequency, float64."""
    wx = 2.0 * np.pi * np.arange(nx) / nx
    wy = 2.0 * np.pi * np.arange(ny // 2 + 1) / ny
    cx = (2.0 * np.cos(wx) - 2.0)[:, None]
    cy = (2.0 * np.cos(wy) - 2.0)[None, :]
    sx = np.sin(wx)[:, None]
    sy = np.sin(wy)[None, :]

    lap = cx + cy
    a00 = mu * lap + (mu + lam) * cx          # x-equation diagonal
    a11 = mu * lap + (mu + lam) * cy          # y-equation diagonal
    a01 = -(mu + lam) * sx * sy               # mixed term (both equations)

    det = a00 * a11 - a01 * a01
    det_safe = np.where(np.abs(det) > 1e-30, det, 1.0)
    i00 = np.where(np.abs(det) > 1e-30, a11 / det_safe, 0.0)
    i11 = np.where(np.abs(det) > 1e-30, a00 / det_safe, 0.0)
    i01 = np.where(np.abs(det) > 1e-30, -a01 / det_safe, 0.0)
    return i00, i11, i01


def _f32(x: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x, np.float32)).to(device)


def make_spectral_navier_lame_solver(nx: int, ny: int, mu: float, lam: float,
                                     dtype=torch.float32):
    """Build ``solve(f [2, nx, ny]) -> v`` with
    ``mu*Lap(v) + (mu+lam)*grad(div(v)) = f`` (discrete, periodic)."""
    coeffs = {}  # the inverse's tables on each device a call came from

    def solve(f: torch.Tensor) -> torch.Tensor:
        if f.device not in coeffs:
            coeffs[f.device] = [_f32(c, f.device) for c in _inverse_coeffs(nx, ny, mu, lam)]
        i00, i11, i01 = coeffs[f.device]
        fhat = torch.fft.rfft2(f.to(torch.float32))  # [2, nx, ny//2+1]
        vx = i00 * fhat[0] + i01 * fhat[1]
        vy = i01 * fhat[0] + i11 * fhat[1]
        v = torch.fft.irfft2(torch.stack([vx, vy]), s=(nx, ny))
        return v.to(dtype)

    return solve


# ---------------------------------------------------------------------------
# Dirichlet (reference-BC) solver via DST-I
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=32)
def _dst1_matrix(m: int) -> np.ndarray:
    """DST-I matrix ``S[k, i] = sin(pi (k+1)(i+1) / (m+1))`` (symmetric;
    ``S @ S = (m+1)/2 * I``). Diagonalizes the 1D Dirichlet second
    difference: eigenvalues ``2 cos(pi (k+1)/(m+1)) - 2``."""
    k = np.arange(1, m + 1)
    return np.sin(np.pi * np.outer(k, k) / (m + 1))


def _dirichlet_eigs(m: int) -> np.ndarray:
    k = np.arange(1, m + 1)
    return 2.0 * np.cos(np.pi * k / (m + 1)) - 2.0


def _pad1(a: torch.Tensor) -> torch.Tensor:
    """A zero ring around the trailing two axes."""
    return F.pad(a, (1, 1, 1, 1))


def _dxy_interior(v: torch.Tensor) -> torch.Tensor:
    """Mixed difference ``0.25 (v_{++} - v_{-+} - v_{+-} + v_{--})`` on the
    interior grid with homogeneous Dirichlet neighbours (zero ring), the
    reference's cross term (``OpticalFlowElastic.cpp:34-38``) at interior
    points when the boundary iterate is zero."""
    vp = _pad1(v)
    return 0.25 * (
        vp[..., 2:, 2:] - vp[..., :-2, 2:] - vp[..., 2:, :-2] + vp[..., :-2, :-2]
    )


def _lap4(a):
    return a[..., 2:, 1:-1] + a[..., :-2, 1:-1] + a[..., 1:-1, 2:] + a[..., 1:-1, :-2]


def _secx(a):
    return a[..., 2:, 1:-1] + a[..., :-2, 1:-1]


def _secy(a):
    return a[..., 1:-1, 2:] + a[..., 1:-1, :-2]


def _dxy(a):
    return 0.25 * (a[..., 2:, 2:] - a[..., :-2, 2:] - a[..., 2:, :-2] + a[..., :-2, :-2])


def apply_navier_lame_operator(v: torch.Tensor, mu: float, lam: float,
                               reference_stencil: bool = True) -> torch.Tensor:
    """The reference's discrete Navier-Lame operator ``A v`` on the full grid
    at interior points (zeros on the border ring), from the SOR fixed-point
    relation of ``OpticalFlowElastic.cpp:21-55``:

      (A v)_c = mu * lap4(v_c) + (mu+lam) * (second_c + cross_c)
                - (6 mu + 2 lam) v_c

    with ``second_c`` the x-direction (reference stencil; the y-component
    asymmetry) or per-component-direction (symmetric) second neighbour sum,
    and ``cross_c`` the mixed difference of the other component. Boundary
    values of ``v`` take part as neighbour values."""
    vx, vy = _pad1(v[0]), _pad1(v[1])
    diag = -(6.0 * mu + 2.0 * lam)
    ax = mu * _lap4(vx) + (mu + lam) * (_secx(vx) + _dxy(vy)) + diag * v[0]
    sec_y = _secx(vy) if reference_stencil else _secy(vy)
    ay = mu * _lap4(vy) + (mu + lam) * (sec_y + _dxy(vx)) + diag * v[1]
    out = torch.stack([ax, ay])
    # The operator is defined on interior points only.
    mask = torch.zeros(v.shape[-2:], dtype=torch.bool, device=v.device)
    mask[1:-1, 1:-1] = True
    return torch.where(mask, out, 0.0)


def make_dirichlet_navier_lame_solver(nx: int, ny: int, mu: float, lam: float,
                                      dtype=torch.float32, reference_stencil: bool = True,
                                      inner_iters: int = 0):
    """Build ``solve(f [2, nx, ny]) -> v`` for the reference's interior-point
    Navier-Lame system with homogeneous Dirichlet borders, the fixed point
    of its SOR relaxation from a zero iterate (``OpticalFlowElastic.cpp:
    21-55``: borders are never written).

    The per-component diagonal part ``mu (d2x + d2y) + (mu+lam) d2_{x|y}``
    is diagonal in the DST-I basis; the ``(mu+lam) dxy`` coupling is not,
    and the operator is symmetric, so the solve is conjugate gradients
    preconditioned by the exact sine-space diagonal solve (8 matmuls an
    inner iteration). ``inner_iters=0`` takes the default: 12, or 32 when
    ``lam > mu``. With the reference's asymmetric stencil and ``lam >
    4 mu`` the preconditioned CG stalls near 1e-1 residual, so that corner
    is refused unless ``inner_iters`` is given."""
    if inner_iters <= 0:
        if reference_stencil and lam > 4 * mu:
            raise ValueError(
                f"spectral_dirichlet with the reference (asymmetric) stencil "
                f"is ill-conditioned for lam ({lam}) > 4*mu ({mu}): the "
                f"preconditioned CG does not reach solve accuracy. Use "
                f"reference_stencil=False, the SOR solver, or pass an "
                f"explicit inner_iters to accept partial convergence."
            )
        inner_iters = 12 if lam <= mu else 32
    mx, my = nx - 2, ny - 2
    if mx < 1 or my < 1:
        raise ValueError("grid too small for an interior Dirichlet solve")
    norm = (2.0 / (mx + 1)) * (2.0 / (my + 1))
    lx = _dirichlet_eigs(mx)[:, None]
    ly = _dirichlet_eigs(my)[None, :]
    d0 = mu * (lx + ly) + (mu + lam) * lx
    d1 = mu * (lx + ly) + (mu + lam) * (lx if reference_stencil else ly)
    # Work with the positive-definite negation: M = -D, Apos = -A.
    inv_md_np = np.stack([-1.0 / d0, -1.0 / d1])
    tables = {}  # the sine matrices and the diagonal on each device a call came from
    diag = -(6.0 * mu + 2.0 * lam)

    def _precond(r, sx, sy, inv_md):
        """Exact solve of the decoupled diagonal system ``M z = r`` in sine
        space: 4 matmuls a component."""
        t = torch.matmul(sx, r)
        t = torch.matmul(t, sy)
        t = t * inv_md
        t = torch.matmul(sx, t)
        t = torch.matmul(t, sy)
        return t * norm

    def _apply_apos(v):
        """``-A v`` on interior arrays ``[2, mx, my]`` with homogeneous
        Dirichlet neighbours (zero ring)."""
        vp = _pad1(v)
        ax = mu * _lap4(vp[0]) + (mu + lam) * (_secx(vp[0]) + _dxy(vp[1])) + diag * v[0]
        sec1 = _secx(vp[1]) if reference_stencil else _secy(vp[1])
        ay = mu * _lap4(vp[1]) + (mu + lam) * (sec1 + _dxy(vp[0])) + diag * v[1]
        return -torch.stack([ax, ay])

    def _dot(a, b):
        return torch.sum(a * b)

    def _safe_div(num, den):
        return torch.where(den != 0, num / torch.where(den != 0, den, 1.0), 0.0)

    def solve(f: torch.Tensor) -> torch.Tensor:
        if f.device not in tables:
            tables[f.device] = [_f32(t, f.device)
                                for t in (_dst1_matrix(mx), _dst1_matrix(my), inv_md_np)]
        sx, sy, inv_md = tables[f.device]
        with full_f32():
            b = -f[:, 1:-1, 1:-1].to(torch.float32)  # Apos x = -f_int
            x = torch.zeros_like(b)
            r = b
            z = _precond(r, sx, sy, inv_md)
            p = z
            rz = _dot(r, z)
            for _ in range(inner_iters):
                ap = _apply_apos(p)
                alpha = _safe_div(rz, _dot(p, ap))
                x = x + alpha * p
                r = r - alpha * ap
                z = _precond(r, sx, sy, inv_md)
                rz_new = _dot(r, z)
                beta = _safe_div(rz_new, rz)
                rz = rz_new
                p = z + beta * p
        out = torch.zeros((2, nx, ny), dtype=torch.float32, device=f.device)
        out[:, 1:-1, 1:-1] = x
        return out.to(dtype)

    return solve
