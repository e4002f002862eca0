"""Shared pieces of the seeded image generators: Gaussian splats rendered
through the FFT, smooth random displacement fields and the resampling of
an image through one.

Every function draws from the ``torch.Generator`` it is given and works
on that generator's device, in a few whole-array calls: the same seed
gives the same images on the same device. Nothing here is read from the
program under test.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def gaussian_splats(shape, centers: torch.Tensor, sigmas: torch.Tensor,
                    amplitudes: torch.Tensor, sigma_levels) -> torch.Tensor:
    """Sum of Gaussian blobs of peak ``amplitudes`` on ``[count, nx, ny]``
    images, periodic at the edges. ``centers [count, m, 2]`` are integer
    pixel positions, ``sigmas [count, m]`` indices into ``sigma_levels``.
    Each level's impulses are blurred in the frequency domain by the
    transform of ``exp(-r^2 / (2 sigma^2))`` (no cuDNN, so the result does
    not depend on an algorithm choice)."""
    count = centers.shape[0]
    nx, ny = shape
    dev = centers.device
    nb = len(sigma_levels)
    impulses = torch.zeros((count, nb * nx * ny), dtype=torch.float32, device=dev)
    index = sigmas.long() * (nx * ny) + centers[..., 0].long() * ny + centers[..., 1].long()
    impulses.scatter_add_(1, index, amplitudes.float())
    spec = torch.fft.rfft2(impulses.view(count, nb, nx, ny))
    fx = torch.fft.fftfreq(nx, device=dev)[:, None]
    fy = torch.fft.rfftfreq(ny, device=dev)[None, :]
    f2 = fx * fx + fy * fy
    total = torch.zeros_like(spec[:, 0])
    for b, s in enumerate(sigma_levels):
        total += spec[:, b] * (2 * math.pi * s * s * torch.exp(-2 * math.pi ** 2 * s * s * f2))
    del impulses, spec
    return torch.fft.irfft2(total, s=(nx, ny))


def smooth_field(count: int, shape, grid: int, peaks: torch.Tensor,
                 gen: torch.Generator) -> torch.Tensor:
    """``count`` smooth displacement fields ``[count, 2, nx, ny]``: normal
    vectors on a ``(grid + 1)^2`` lattice, bicubic over the image, each
    scaled so that its largest per-pixel magnitude is its entry of
    ``peaks`` (px)."""
    dev = peaks.device
    coarse = torch.randn((count, 2, grid + 1, grid + 1), generator=gen, device=dev)
    d = F.interpolate(coarse, size=tuple(shape), mode="bicubic", align_corners=True)
    mag = torch.sqrt(d[:, 0] ** 2 + d[:, 1] ** 2).amax(dim=(-2, -1))
    return d * (peaks / mag)[:, None, None, None]


def resample(images: torch.Tensor, disp: torch.Tensor) -> torch.Tensor:
    """``images [count, nx, ny]`` sampled at ``x + disp(x)`` (bilinear,
    the border value past the edge): the moving image of a pair."""
    count, nx, ny = images.shape
    dev = images.device
    gi = torch.arange(nx, dtype=torch.float32, device=dev)[:, None] + disp[:, 0]
    gj = torch.arange(ny, dtype=torch.float32, device=dev)[None, :] + disp[:, 1]
    # grid_sample's last grid axis is (width, height) = (ny, nx), normalised
    # to [-1, 1] corner to corner.
    grid = torch.stack([gj * (2.0 / (ny - 1)) - 1.0, gi * (2.0 / (nx - 1)) - 1.0], dim=-1)
    out = F.grid_sample(images[:, None], grid, mode="bilinear", padding_mode="border",
                        align_corners=True)
    return out[:, 0]


def minmax(images: torch.Tensor) -> torch.Tensor:
    """Each image of ``[count, nx, ny]`` scaled to [0, 1]."""
    lo = images.amin(dim=(-2, -1), keepdim=True)
    hi = images.amax(dim=(-2, -1), keepdim=True)
    return (images - lo) / (hi - lo)


def fixed_set_in_seeded_order(lo: float, hi: float, count: int, gen: torch.Generator,
                              device) -> torch.Tensor:
    """``count`` values evenly spaced over ``[lo, hi]``, in an order drawn
    from ``gen``: every seed gets the same set of sizes, so the work of a
    run does not depend on its seed."""
    values = torch.linspace(lo, hi, count, device=device)
    return values[torch.randperm(count, generator=gen, device=device)]
