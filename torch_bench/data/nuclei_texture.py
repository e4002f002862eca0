"""Histology-like slide pairs: a nuclei texture and its resampling through
a smooth random displacement field.

The reference image is a field of Gaussian blobs (nuclei) of sigma drawn
from ``blob_sigma_px`` at random places and amplitudes, min-max scaled to
[0, 1]. The moving image is the reference sampled at ``x + d(x)``, ``d``
smooth (a bicubic lattice of ``displacement_grid`` cells) with its peak
magnitude taken from an evenly spaced set over ``displacement_peak_px``,
one value a pair, in an order drawn from the seed.
"""

from __future__ import annotations

import torch

from torch_bench.data import synth


def make_pool(data: dict, dims, count: int, seed: int, device, pairs: int = 1) -> list:
    """``count`` pairs ``(iref, imov)`` of ``dims``, float32 on ``device``:
    one pair a request (``pairs`` 1)."""
    if pairs != 1:
        raise ValueError(f"nuclei_texture makes one pair a request, not {pairs}")
    gen = torch.Generator(device=device).manual_seed(seed)
    nx, ny = dims
    lo, hi = data["blob_sigma_px"]
    levels = [float(s) for s in range(int(lo), int(hi) + 1)]
    m = round(data["blobs_per_mpix"] * nx * ny / 1e6)
    peaks = synth.fixed_set_in_seeded_order(*data["displacement_peak_px"], count, gen, device)
    disp = synth.smooth_field(count, dims, data["displacement_grid"], peaks, gen)
    pool = []
    for p in range(count):
        centers = torch.stack([torch.randint(0, nx, (1, m), generator=gen, device=device),
                               torch.randint(0, ny, (1, m), generator=gen, device=device)], -1)
        sigmas = torch.randint(0, len(levels), (1, m), generator=gen, device=device)
        amps = torch.empty((1, m), device=device).uniform_(*data["amplitude"], generator=gen)
        iref = synth.minmax(synth.gaussian_splats(dims, centers, sigmas, amps, levels))
        imov = synth.resample(iref, disp[p:p + 1])
        pool.append((iref[0].contiguous(), imov[0].contiguous()))
    return pool
