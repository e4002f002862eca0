"""4DCT lung scans, synthetic: a thoracic phantom of axial slices in HU and
its expiratory phases, registered slice by slice against end-inhale.

A scan of ``slices`` axial slices (apex to base) is built in HU: air
outside a body ellipse of soft tissue, two lungs whose cross-section grows
from the apex towards the base and vanishes in the end slices, vessels as
Gaussian splats inside the lungs, a bright spine and rib arcs that come
and go along z. T00 (end-inhale) is the scan with Gaussian noise. Phase
``p`` (T10 ... T50 for ``p`` 1 ... 5) is the scan resampled in-plane
(bilinear) through one smooth field, on a lattice of ``displacement_grid``
cells in-plane (bicubic) and ``displacement_grid_z`` cells along z
(linear), weighted to be largest at the base, and scaled to a peak of
``(1 - cos(pi p / (phase_count / 2))) / 2`` times the scan's T50 peak;
then its own noise. The T50 peaks are evenly spaced over
``displacement_peak_px``, one a scan, in an order drawn from the seed.
Each slice is min-max scaled to [0, 1] on its own, as the upstream demo
scales its two images.

A pool entry is ``(irefs, imovs)``, each ``[pairs, nx, ny]``, phase-major:
pair ``k`` is slice ``k mod slices`` of phase ``phases[k // slices]``
against the same slice of T00. ``pairs`` is ``len(phases) * slices`` for
the configured scan; any other count takes the first ``pairs`` of a scan
of ``ceil(pairs / len(phases))`` slices (a small scan for tests).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from torch_bench.data import synth


def _soft(inside: torch.Tensor) -> torch.Tensor:
    """A mask from a signed distance in pixels (positive inside), with a
    ramp of about two pixels across the edge."""
    return torch.sigmoid(inside)


def _ellipse(x, y, cx, cy, ax, ay, px: float) -> torch.Tensor:
    """Signed distance in pixels, roughly, to an ellipse of semi-axes
    ``ax``, ``ay`` (fractions of the half extent ``px`` pixels) centred at
    ``(cx, cy)``; ``ax``, ``ay`` may be ``[slices, 1, 1]``."""
    r = torch.sqrt(((x - cx) / ax) ** 2 + ((y - cy) / ay) ** 2)
    return (1.0 - r) * torch.minimum(ax, ay) * px


def heights(slices: int, device) -> torch.Tensor:
    """Each slice's height in the scan, 0 at the apex and 1 at the base:
    the middle of its share."""
    return (torch.arange(slices, device=device, dtype=torch.float32) + 0.5) / slices


def lung_profile(t: torch.Tensor) -> torch.Tensor:
    """The lungs' relative size at height ``t`` (0 apex, 1 base of the
    scan): 0 in the end slices, growing from the apex, largest in the
    lower third, falling to 0 at the diaphragm."""
    s = ((t - 0.04) / 0.92).clamp(0.0, 1.0)
    return torch.sqrt(s) * (1.0 - s ** 8)


def phantom(data: dict, slices: int, dims, gen: torch.Generator, device) -> torch.Tensor:
    """The scan ``[slices, nx, ny]`` in HU, without noise."""
    nx, ny = dims
    px = min(nx, ny) / 2.0
    x = torch.linspace(-1.0, 1.0, nx, device=device)[None, :, None]
    y = torch.linspace(-1.0, 1.0, ny, device=device)[None, None, :]
    t = heights(slices, device)[:, None, None]
    one = torch.ones_like(t)
    body = _soft(_ellipse(x, y, 0.0, 0.0, 0.72 * one, 0.92 * one, px))
    w = lung_profile(t).clamp_min(1e-3)
    lungs = (_soft(_ellipse(x, y, -0.05, -0.42, 0.52 * w, 0.30 * w, px))
             + _soft(_ellipse(x, y, -0.05, 0.42, 0.52 * w, 0.30 * w, px)))
    lungs = lungs * (lung_profile(t) > 0)
    # Ribs: a band just inside the body's edge, in arcs along its sides and
    # back, crossing the slice where a cosine along z is high.
    ring = _soft(_ellipse(x, y, 0.0, 0.0, 0.69 * one, 0.89 * one, px)) * _soft(
        -_ellipse(x, y, 0.0, 0.0, 0.64 * one, 0.84 * one, px))
    arcs = (x > -0.35).float()
    ribs = ring * arcs * (torch.cos(2 * math.pi * t * data["rib_pairs"]) > 0.55)
    spine = _soft(_ellipse(x, y, 0.58, 0.0, 0.10 * one, 0.10 * one, px))
    lo, hi = data["vessel_sigma_px"]
    levels = [float(s) for s in range(int(lo), int(hi) + 1)]
    m = max(round(data["vessels_per_mpix"] * nx * ny / 1e6), 1)
    centers = torch.stack([torch.randint(0, nx, (slices, m), generator=gen, device=device),
                           torch.randint(0, ny, (slices, m), generator=gen, device=device)], -1)
    sigmas = torch.randint(0, len(levels), (slices, m), generator=gen, device=device)
    amps = torch.empty((slices, m), device=device).uniform_(*data["vessel_hu"], generator=gen)
    vessels = synth.gaussian_splats(dims, centers, sigmas, amps, levels)
    hu = data["hu"]
    scan = hu["air"] + (hu["soft_tissue"] - hu["air"]) * body
    scan = scan + (hu["lung"] - hu["soft_tissue"]) * lungs + vessels * lungs
    return scan + (hu["bone"] - hu["soft_tissue"]) * torch.maximum(ribs, spine)


def breathing_field(data: dict, slices: int, dims, gen: torch.Generator,
                    device) -> torch.Tensor:
    """A smooth in-plane field ``[slices, 2, nx, ny]`` of peak magnitude 1,
    largest at the base: normal vectors on a lattice of ``displacement_grid
    + 1`` nodes a side in-plane and ``displacement_grid_z + 1`` along z,
    linear along z and bicubic in-plane, weighted by 0.25 at the apex
    rising linearly to 1 at the base."""
    grid, grid_z = data["displacement_grid"], data["displacement_grid_z"]
    coarse = torch.randn((1, 2, grid_z + 1, grid + 1, grid + 1), generator=gen, device=device)
    along_z = F.interpolate(coarse, size=(slices, grid + 1, grid + 1), mode="trilinear",
                            align_corners=True)[0].transpose(0, 1).contiguous()
    d = F.interpolate(along_z, size=tuple(dims), mode="bicubic", align_corners=True)
    d = d * (0.25 + 0.75 * heights(slices, device))[:, None, None, None]
    return d / torch.sqrt(d[:, 0] ** 2 + d[:, 1] ** 2).amax()


def phase_scale(p: int, phase_count: int) -> float:
    """The field's share of its T50 peak at phase ``p``: 0 at T00, 1 at
    the end of expiration, half a cosine between."""
    return (1.0 - math.cos(math.pi * p / (phase_count / 2))) / 2.0


def make_pool(data: dict, dims, count: int, seed: int, device, pairs: int) -> list:
    """``count`` scans' sweeps ``(irefs, imovs)``, each ``[pairs, nx, ny]``
    float32 on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    phases = data["phases"]
    slices = data["slices"] if pairs == len(phases) * data["slices"] else -(-pairs // len(phases))
    peaks = synth.fixed_set_in_seeded_order(*data["displacement_peak_px"], count, gen, device)
    noise = data["noise_hu"]
    pool = []
    for c in range(count):
        scan = phantom(data, slices, dims, gen, device)
        field = breathing_field(data, slices, dims, gen, device) * peaks[c]
        t00 = scan + noise * torch.randn(scan.shape, generator=gen, device=device)
        irefs = synth.minmax(t00).repeat(len(phases), 1, 1)[:pairs].contiguous()
        del t00
        imovs = torch.empty_like(irefs)
        for i, p in enumerate(phases):
            k = i * slices
            if k >= pairs:
                break
            n = min(slices, pairs - k)
            moved = synth.resample(scan[:n], field[:n] * phase_scale(p, data["phase_count"]))
            moved += noise * torch.randn(moved.shape, generator=gen, device=device)
            imovs[k:k + n] = synth.minmax(moved)
            del moved
        pool.append((irefs, imovs))
        del scan, field
    return pool
