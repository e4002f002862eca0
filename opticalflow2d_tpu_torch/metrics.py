"""Registration quality metrics (PyTorch port of
``opticalflow2d_tpu.metrics``): warped-image SSD and endpoint error."""

from __future__ import annotations

import torch

from opticalflow2d_tpu_torch.ops.reduce import ssd
from opticalflow2d_tpu_torch.ops.warp import warp2d


def endpoint_error(u_a: torch.Tensor, u_b: torch.Tensor) -> torch.Tensor:
    """Mean Euclidean distance between two motion fields ``[2, nx, ny]``."""
    d = u_a - u_b
    return torch.mean(torch.sqrt(d[..., 0, :, :] ** 2 + d[..., 1, :, :] ** 2), dim=(-2, -1))


def warped_ssd(iref: torch.Tensor, imov: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """SSD between the reference image and the motion-warped moving image."""
    return ssd(iref, warp2d(imov, u))


def ssd_reduction(iref: torch.Tensor, imov: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Fractional SSD reduction achieved by the registration (1 = perfect)."""
    before = ssd(iref, imov)
    after = warped_ssd(iref, imov, u)
    return 1.0 - after / before.clamp_min(torch.finfo(iref.dtype).tiny)
