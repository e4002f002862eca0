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

from opticalflow2d_tpu_torch.kernels import downsample as downsample_kernel
from opticalflow2d_tpu_torch.kernels import upsample as upsample_kernel
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


def _interleaved(terms, n_acc: int):
    """``n_acc`` partial sums, term k into sum ``k % n_acc``, each a running
    sum, then added pairwise. ``n_acc = 1`` is one running sum."""
    acc = [_sequential(terms[r::n_acc]) for r in range(min(n_acc, len(terms)))]
    while len(acc) > 1:
        acc = [acc[i] + acc[i + 1] if i + 1 < len(acc) else acc[i]
               for i in range(0, len(acc), 2)]
    return acc[0]


def box_product_accumulators(shape, ny_out: int) -> Tuple[int, int]:
    """``(a, b)``: the partial sums in which XLA on the CPU adds the x
    offsets (``a``) and then the y offsets (``b``) of the JAX package's two
    box products past 4096, for an input of ``shape [..., nx_in, ny_in]``.
    Found by probing nx_in in {4104, 8224, 12288, 16384} and ny_in in
    {16, ..., 256} (and 512, 1024 at 4104), 2D and ``[2, nx, ny]``,
    levels 2 and 3 of the tiled pair: every pixel follows
    - ``b = clamp(64 // ny_out, 1, 4)``;
    - a 2D image: ``a = clamp(64 // ny_in, 1, 4)``;
    - a stack: ``a = 4`` up to nx_in = 8224 and 1 from 12288 on.
    The shapes left unprobed are listed in ROADMAP queue C."""
    nx_in, ny_in = shape[-2], shape[-1]
    b = min(4, max(1, 64 // ny_out))
    if len(shape) == 2:
        return min(4, max(1, 64 // ny_in)), b
    return (4 if nx_in <= 8224 else 1), b


def box_mean(image: torch.Tensor, fx: int, fy: int) -> torch.Tensor:
    """Mean over the ``fx x fy`` patches of ``[..., fx * m, fy * n]``, added
    in the order in which XLA on the CPU rounds the JAX package's
    ``reshape(..., m, fx, n, fy).mean(axis=(-3, -1))``: the patch row by row
    (x offset outer, y offset inner) in one running sum; but for a 2x2
    patch on a grid whose ``ny`` is a power of two, each row's pair first
    and then the rows. The strip pyramid (``parallel.spatial``) takes it on
    each strip's own shape, as the JAX package's strip downsample
    (``spatial.py:1114``) reshapes the strip."""
    ny = image.shape[-1]
    c = [[image[..., a::fx, b::fy] for b in range(fy)] for a in range(fx)]
    if fx == fy == 2 and ny & (ny - 1) == 0:
        total = _sequential([c[a][0] + c[a][1] for a in range(fx)])
    else:
        total = _sequential([c[a][b] for a in range(fx) for b in range(fy)])
    return total / (fx * fy)


def downsample_image(image: torch.Tensor, dimout: Tuple[int, int]) -> torch.Tensor:
    """Box-filter downsample ``[..., nx, ny] -> [..., nx_out, ny_out]``: the
    plain version (``kernels/downsample.py::downsample_image_ref``) on the
    CPU, one kernel on CUDA.

    Each patch is added in a fixed order (not a reduction, whose order
    differs between devices), so a level rounds alike on the CPU and the
    GPU. The order is the one in which the JAX package's two forms round on
    the CPU (``opticalflow2d_tpu/ops/resample.py:42-66``), found by probing
    XLA:
    - extents <= 4096, ``reshape(...).mean()``: ``box_mean`` on the
      cropped grid;
    - extents > 4096, the two box products: the x offsets first, the
      terms scaled by ``1/fx`` added into ``a`` partial sums (offset mod
      ``a``), each a running sum, then pairwise; then the y offsets,
      scaled by ``1/fy``, into ``b`` partial sums the same way, with
      ``(a, b)`` from the shape (``box_product_accumulators``).
    Scaling by a power of two is exact, so the forms differ only in
    the order of the adds. The mean's divide by ``fx * fy`` runs on CUDA as
    the product with its float32 reciprocal (PyTorch divides a CUDA tensor
    by a host scalar so), which equals the CPU's divide for every
    power-of-two patch.
    """
    return downsample_kernel.downsample_image(image, dimout)


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
    ratio (reference ``src/Motion.cpp:87-111``): ``downsample_image`` times
    ``_motion_ratio`` on the CPU, one kernel on CUDA
    (``kernels/downsample.py``)."""
    return downsample_kernel.downsample_motion(u, dimout)


def upsample_motion(u: torch.Tensor, dimout: Tuple[int, int]) -> torch.Tensor:
    """Bilinear upsample a motion field and rescale its components by the
    dim ratio (reference ``src/Motion.cpp:61-85``): ``upsample_image`` times
    ``_motion_ratio`` on the CPU, one kernel on CUDA
    (``kernels/upsample.py``)."""
    return upsample_kernel.upsample_motion(u, dimout)
