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


def _sequential(terms):
    total = terms[0]
    for t in terms[1:]:
        total = total + t
    return total


def _interleaved4(terms):
    """Four partial sums, term k into sum ``k % 4``, added pairwise."""
    acc = [_sequential(terms[r::4]) for r in range(min(4, len(terms)))]
    while len(acc) > 1:
        acc = [acc[i] + acc[i + 1] if i + 1 < len(acc) else acc[i]
               for i in range(0, len(acc), 2)]
    return acc[0]


def downsample_image(image: torch.Tensor, dimout: Tuple[int, int]) -> torch.Tensor:
    """Box-filter downsample ``[..., nx, ny] -> [..., nx_out, ny_out]``.

    Each patch is added as a fixed sequence of tensor adds (not a
    reduction, whose order differs between devices), so a level rounds
    alike on the CPU and the GPU. The sequence is the one in which the JAX
    package's two forms round on the CPU (``opticalflow2d_tpu/ops/
    resample.py:42-66``), found by probing XLA:
    - extents <= 4096, ``reshape(...).mean()``: the patch row by row
      (x offset outer, y offset inner) in one running sum; but for a 2x2
      patch on a grid whose cropped ``ny`` is a power of two, each row's
      pair first and then the rows;
    - extents > 4096, the two box products: the x offsets first, one
      running sum of the terms scaled by ``1/fx``; then the y offsets,
      scaled by ``1/fy``, into four partial sums (offset mod 4) added
      pairwise. Exact for 2D images at 8224x64, levels 1-3; the shapes
      where XLA's product orders differ are listed in ROADMAP queue C.
    Scaling by a power of two is exact, so the forms differ only in
    the order of the adds.
    """
    nx_in, ny_in = image.shape[-2], image.shape[-1]
    nx_out, ny_out = dimout
    if nx_out > nx_in or ny_out > ny_in:
        raise ValueError("downsample target must not exceed source dims")
    fx = nx_in // nx_out
    fy = ny_in // ny_out
    cropped = image[..., : nx_out * fx, : ny_out * fy]
    c = [[cropped[..., a::fx, b::fy] for b in range(fy)] for a in range(fx)]
    if nx_in > 4096 or ny_in > 4096:
        sx, sy = 1.0 / fx, 1.0 / fy
        cols = [_sequential([c[a][b] * sx for a in range(fx)]) for b in range(fy)]
        return _interleaved4([col * sy for col in cols])
    ny_c = ny_out * fy
    if fx == fy == 2 and ny_c & (ny_c - 1) == 0:
        total = _sequential([c[a][0] + c[a][1] for a in range(fx)])
    else:
        total = _sequential([c[a][b] for a in range(fx) for b in range(fy)])
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
