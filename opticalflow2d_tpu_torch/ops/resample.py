"""Pyramid resampling (PyTorch port of ``opticalflow2d_tpu.ops.resample``).

- Downsample: mean over ``factor x factor`` patches anchored at
  ``(i*factor_x, j*factor_y)`` (reference ``src/Field.tpp:76-143``).
- Upsample: corner-anchored bilinear interpolation with edge-weight
  renormalization (reference ``src/Field.tpp:146-206``).
- Motion variants scale each displacement component by the dimension ratio
  target/source (reference ``src/Motion.cpp:61-111``).

The taps are read by direct indexing on every device; the JAX package's
one-hot and box matmuls only stood in for the gather a TPU lacks.
"""

from __future__ import annotations

from typing import Tuple

import torch

from opticalflow2d_tpu_torch.kernels.warp_fused import bilinear


def pyramid_dims(dim0: Tuple[int, int], nscales: int):
    """Per-scale dims ``dim0 / 2^s`` (float division then truncation), as
    the reference constructs them (``src/ImageRegistration.cpp:54-61``)."""
    nx, ny = dim0
    return [(int(nx / (2.0 ** s)), int(ny / (2.0 ** s))) for s in range(nscales + 1)]


def downsample_image(image: torch.Tensor, dimout: Tuple[int, int]) -> torch.Tensor:
    """Box-filter downsample ``[..., nx, ny] -> [..., nx_out, ny_out]``."""
    nx_in, ny_in = image.shape[-2], image.shape[-1]
    nx_out, ny_out = dimout
    if nx_out > nx_in or ny_out > ny_in:
        raise ValueError("downsample target must not exceed source dims")
    fx = nx_in // nx_out
    fy = ny_in // ny_out
    cropped = image[..., : nx_out * fx, : ny_out * fy]
    # The patch sum is added in a fixed order (not a reduction, whose order
    # differs between devices), so a level rounds alike on the CPU and the
    # GPU: a run on either device sees the same pyramid.
    total = None
    for a in range(fx):
        for b in range(fy):
            term = cropped[..., a::fx, b::fy]
            total = term if total is None else total + term
    return total / (fx * fy)


def upsample_image(image: torch.Tensor, dimout: Tuple[int, int]) -> torch.Tensor:
    """Corner-anchored bilinear upsample ``[C?, nx, ny] -> [C?, nx_out, ny_out]``:
    output (i, j) samples ``(i * nx_in / nx_out, j * ny_in / ny_out)``
    (reference ``src/Field.tpp:172-173``)."""
    nx_in, ny_in = image.shape[-2], image.shape[-1]
    nx_out, ny_out = dimout
    if nx_out < nx_in or ny_out < ny_in:
        raise ValueError("upsample target must not be below source dims")
    kw = dict(dtype=image.dtype, device=image.device)
    # The ratios round to the image dtype before the product, as JAX's
    # weakly typed Python scalars do.
    px = torch.arange(nx_out, **kw)[:, None] * torch.tensor(nx_in / nx_out, **kw)
    py = torch.arange(ny_out, **kw)[None, :] * torch.tensor(ny_in / ny_out, **kw)
    px, py = torch.broadcast_tensors(px, py)
    squeeze = image.dim() == 2
    data = image[None] if squeeze else image
    value, weight, _ = bilinear(data, px, py)
    out = value / torch.where(weight != 0, weight, 1.0)
    return out[0] if squeeze else out


def _motion_ratio(u: torch.Tensor, dimout: Tuple[int, int]) -> torch.Tensor:
    nx_in, ny_in = u.shape[-2], u.shape[-1]
    nx_out, ny_out = dimout
    return torch.tensor(
        [nx_out / nx_in, ny_out / ny_in], dtype=u.dtype, device=u.device
    ).reshape((2,) + (1,) * (u.dim() - 1))


def downsample_motion(u: torch.Tensor, dimout: Tuple[int, int]) -> torch.Tensor:
    """Box downsample a motion field and rescale its components by the dim
    ratio (reference ``src/Motion.cpp:87-111``)."""
    return downsample_image(u, dimout) * _motion_ratio(u, dimout)


def upsample_motion(u: torch.Tensor, dimout: Tuple[int, int]) -> torch.Tensor:
    """Bilinear upsample a motion field and rescale its components by the
    dim ratio (reference ``src/Motion.cpp:61-85``)."""
    return upsample_image(u, dimout) * _motion_ratio(u, dimout)
