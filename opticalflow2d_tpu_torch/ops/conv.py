"""Boundary-renormalized 2D convolution and Gaussian kernels (PyTorch port of
``opticalflow2d_tpu.ops.conv``).

The reference convolves with a dense, normalized k x k kernel and renormalizes
by the sum of in-bounds kernel weights at each pixel (``src/Field.tpp:210-269``,
``src/Kernel.cpp:45-73``). The Gaussian factorizes, so the clipped variant is
computed separably and exactly as

    out = sepconv(field, gx, gy) / (denx (x) deny)

with the x pass first, then y, taps added in index order: the order the
JAX package uses and the demons kernels repeat.

``convolve2d_flatwrap`` reproduces the reference's flat-index bounds-check bug
(``src/Field.tpp:245-246``): taps wrap across row boundaries in x instead of
clipping. It exists for compatibility runs only.
"""

from __future__ import annotations

import numpy as np
import torch


def gaussian_kernel_1d(sigma: float, width: int) -> np.ndarray:
    """Unnormalized 1D Gaussian taps ``exp(-(t-c)^2 / (2 sigma^2))`` with
    center ``c = (width-1)//2`` (reference ``src/Kernel.cpp:52-61``; overall
    normalization cancels in the renormalized convolution)."""
    c = (width - 1) // 2
    t = np.arange(width, dtype=np.float64)
    return np.exp(-((t - c) ** 2) / (2.0 * sigma * sigma))


def gaussian_taps(sigma: float, width: int) -> list:
    """The 1D taps as the float32 values a float32 field is multiplied by
    (JAX rounds a weakly typed Python scalar so)."""
    return [float(v) for v in gaussian_kernel_1d(sigma, width).astype(np.float32)]


def gaussian_kernel_2d(sigma: float, width: int) -> np.ndarray:
    """Normalized dense 2D Gaussian, exactly the reference's
    ``Kernel::set_gaussian`` (``src/Kernel.cpp:45-73``)."""
    g = gaussian_kernel_1d(sigma, width)
    k = np.outer(g, g)
    return k / k.sum()


def _sepconv_axis(f: torch.Tensor, taps: list, axis: int) -> torch.Tensor:
    """Correlate ``f`` with ``taps`` along ``axis`` with zero padding, the
    terms added in tap order."""
    k = len(taps)
    c = (k - 1) // 2
    axis = axis % f.dim()
    pad = [0, 0] * (f.dim() - 1 - axis) + [c, c]
    fp = torch.nn.functional.pad(f, pad)
    n = f.shape[axis]
    out = None
    for t in range(k):
        term = fp.narrow(axis, t, n) * taps[t]
        out = term if out is None else out + term
    return out


def convolve2d_clip(f: torch.Tensor, sigma: float, width: int) -> torch.Tensor:
    """Boundary-renormalized Gaussian convolution with clipped (non-wrapping)
    edges, computed separably. Operates on the trailing two axes."""
    taps = gaussian_taps(sigma, width)
    num = _sepconv_axis(_sepconv_axis(f, taps, -2), taps, -1)
    nx, ny = f.shape[-2], f.shape[-1]
    denx = _sepconv_axis(torch.ones(nx, dtype=f.dtype, device=f.device), taps, 0)
    deny = _sepconv_axis(torch.ones(ny, dtype=f.dtype, device=f.device), taps, 0)
    return num / (denx[:, None] * deny[None, :])


def _tap_weight_rows(gi: torch.Tensor, n: int, taps: list, dtype) -> torch.Tensor:
    """The renormalization along x at global rows ``gi``: the taps whose
    source row lies in ``[0, n)``, added in tap order as ``convolve2d_clip``
    adds its convolved ones."""
    c = (len(taps) - 1) // 2
    out = None
    for t, w in enumerate(taps):
        tap = torch.tensor(w, dtype=dtype, device=gi.device)
        term = torch.where((gi + t - c >= 0) & (gi + t - c < n), tap, 0.0)
        out = term if out is None else out + term
    return out


def convolve2d_clip_rows(f: torch.Tensor, gi0: int, nx: int, sigma: float,
                         width: int) -> torch.Tensor:
    """``convolve2d_clip`` on the rows of a strip: ``f [..., m + 2c, ny]``
    holds rows ``gi0 .. gi0 + m + 2c`` of an image of ``nx`` rows (``c =
    width // 2``), and the result is its ``m`` middle rows. A row outside
    the image counts as 0, whatever ``f`` holds there, and the
    renormalization comes from the global rows, so the result equals
    ``convolve2d_clip`` of the whole image on those rows bit for bit."""
    taps = gaussian_taps(sigma, width)
    c = (len(taps) - 1) // 2
    m = f.shape[-2] - 2 * c
    gi = torch.arange(gi0, gi0 + m + 2 * c, device=f.device)[:, None]
    inside = (gi >= 0) & (gi < nx)
    num_x = None
    for t, w in enumerate(taps):
        term = torch.where(inside[t:t + m], f.narrow(-2, t, m) * w, 0.0)
        num_x = term if num_x is None else num_x + term
    num = _sepconv_axis(num_x, taps, -1)
    ny = f.shape[-1]
    denx = _tap_weight_rows(gi[c:c + m, 0], nx, taps, f.dtype)
    deny = _sepconv_axis(torch.ones(ny, dtype=f.dtype, device=f.device), taps, 0)
    return num / (denx[:, None] * deny[None, :])


def convolve2d_flatwrap(f: torch.Tensor, sigma: float, width: int) -> torch.Tensor:
    """Bug-compatible renormalized convolution: bounds are checked on the
    *flat* x-fastest index, so x-edge taps wrap into the adjacent row
    (reference ``src/Field.tpp:242-258``). Dense k^2 taps over a flattened
    array, on the trailing two axes ``[..., nx, ny]``."""
    k2d = gaussian_kernel_2d(sigma, width)
    c = (width - 1) // 2
    nx, ny = f.shape[-2], f.shape[-1]
    size = nx * ny
    # Reference flat layout is x-fastest: flat[i + j*nx] = f[i, j].
    ft = f.transpose(-1, -2)  # [..., ny, nx]
    flat = ft.reshape(*ft.shape[:-2], size)
    idx = torch.arange(size, device=f.device)
    num = torch.zeros_like(flat)
    den = torch.zeros(size, dtype=f.dtype, device=f.device)
    for ii in range(-c, c + 1):
        for jj in range(-c, c + 1):
            o = ii + jj * nx
            w = float(np.float32(k2d[ii + c, jj + c]))
            mask = (idx + o >= 0) & (idx + o < size)
            shifted = torch.roll(flat, -o, dims=-1)
            num = num + torch.where(mask, shifted * w, 0.0)
            den = den + torch.where(mask, w, 0.0)
    out_t = (num / den).reshape(*ft.shape[:-2], ny, nx)
    return out_t.transpose(-1, -2)


def gaussian_smooth(f: torch.Tensor, sigma: float, width: int,
                    flatwrap: bool = False) -> torch.Tensor:
    """Renormalized Gaussian smoothing; ``flatwrap`` selects the
    bug-compatible edge behavior."""
    if flatwrap:
        return convolve2d_flatwrap(f, sigma, width)
    return convolve2d_clip(f, sigma, width)


def box_kernel_2d(width: int) -> np.ndarray:
    """Uniform averaging kernel, the reference's ``Kernel::set_average``
    (``src/Kernel.cpp:75-82``; dead code there, provided for API parity)."""
    return np.full((width, width), 1.0 / (width * width))


def convolve2d_kernel(f: torch.Tensor, k2d: np.ndarray) -> torch.Tensor:
    """Renormalized clipped convolution with an arbitrary dense 2D kernel
    (odd dims), the general form of the reference's ``Field::convolute``
    (``src/Field.tpp:210-269``, with the flat-wrap defect fixed), over the
    trailing two axes."""
    kx, ky = k2d.shape
    cx, cy = (kx - 1) // 2, (ky - 1) // 2
    nx, ny = f.shape[-2], f.shape[-1]
    fp = torch.nn.functional.pad(f, [cy, cy, cx, cx])
    ones = torch.nn.functional.pad(torch.ones((nx, ny), dtype=f.dtype, device=f.device),
                                   [cy, cy, cx, cx])
    num = None
    den = None
    for i in range(kx):
        for j in range(ky):
            w = float(np.float32(k2d[i, j]))
            sl_f = fp[..., i:i + nx, j:j + ny] * w
            sl_o = ones[i:i + nx, j:j + ny] * w
            num = sl_f if num is None else num + sl_f
            den = sl_o if den is None else den + sl_o
    return num / den
