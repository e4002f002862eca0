"""Fluorescence time-lapse series: a sparse field of large nuclei with a
finer texture inside them, moved a little from one frame to the next.

Frame 0 is a sum of Gaussian nuclei of sigma drawn from
``nucleus_sigma_px`` at random places and amplitudes, multiplied by a
texture of finer Gaussian splats (sigma from ``texture_sigma_px``) that
ranges over ``[texture_floor, 1]``, and min-max scaled to [0, 1]. Frame
``t + 1`` is frame ``t`` sampled at ``x + d_t(x)``, ``d_t`` smooth (a
bicubic lattice of ``displacement_grid`` cells) with its peak magnitude
taken from an evenly spaced set over ``displacement_peak_px``, one value
a frame pair across the whole pool, in an order drawn from the seed.
Pair ``t`` of a series is ``(frame t, frame t + 1)``.
"""

from __future__ import annotations

import torch

from torch_bench.data import synth


def _splats(gen, count: int, dims, per_mpix: float, sigma_px, amplitude, device):
    """``count`` images of Gaussian splats, ``per_mpix`` a megapixel."""
    nx, ny = dims
    levels = [float(s) for s in range(int(sigma_px[0]), int(sigma_px[1]) + 1)]
    m = max(round(per_mpix * nx * ny / 1e6), 1)
    centers = torch.stack([torch.randint(0, nx, (count, m), generator=gen, device=device),
                           torch.randint(0, ny, (count, m), generator=gen, device=device)], -1)
    sigmas = torch.randint(0, len(levels), (count, m), generator=gen, device=device)
    amps = torch.empty((count, m), device=device).uniform_(*amplitude, generator=gen)
    return synth.gaussian_splats(dims, centers, sigmas, amps, levels)


def make_pool(data: dict, dims, count: int, seed: int, device, pairs: int) -> list:
    """``count`` series ``(irefs, imovs)``, each ``[pairs, nx, ny]`` float32
    on ``device``: views of one series of ``pairs + 1`` frames, ``imovs[t]``
    the frame after ``irefs[t]``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    nuclei = _splats(gen, count, dims, data["nuclei_per_mpix"], data["nucleus_sigma_px"],
                     data["nucleus_amplitude"], device)
    texture = synth.minmax(_splats(gen, count, dims, data["texture_per_mpix"],
                                   data["texture_sigma_px"], data["texture_amplitude"], device))
    floor = data["texture_floor"]
    frame = synth.minmax(nuclei * (floor + (1.0 - floor) * texture))
    del nuclei, texture
    peaks = synth.fixed_set_in_seeded_order(*data["displacement_peak_px"], count * pairs, gen,
                                            device)
    frames = [frame]
    for t in range(pairs):
        disp = synth.smooth_field(count, dims, data["displacement_grid"],
                                  peaks[t * count:(t + 1) * count], gen)
        frames.append(synth.resample(frames[-1], disp))
    series = torch.stack(frames, dim=1)  # [count, pairs + 1, nx, ny]
    return [(series[c, :-1], series[c, 1:]) for c in range(count)]
