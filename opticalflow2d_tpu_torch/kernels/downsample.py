"""Box downsample of an image or a motion field in one pass (CUDA
``csrc/downsample.cu``).

Each pyramid level is taken straight from the full-resolution image, and
each level's motion seed from the full-resolution field
(``engine/registration.py``, reference ``src/Field.tpp:76-143``,
``src/Motion.cpp:87-111``). No TPU kernel did this: the JAX package
downsamples in jnp (``opticalflow2d_tpu/ops/resample.py``). The kernel
replaces the plain version's one strided tensor op a term of each patch with
one launch that reads the input once and writes only the output, adds each
patch in the plain version's order (``downsample_order``), and rounds its
factors and a motion's ratios on the host, so it makes no device tensor from
a Python float and does not synchronise.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import numpy as np
import torch

from opticalflow2d_tpu_torch import kernels
from opticalflow2d_tpu_torch.kernels import _build
from opticalflow2d_tpu_torch.ops import resample

# How a patch is added (``csrc/downsample.cu`` Form).
MEAN, MEAN_PAIRS, PRODUCTS = 0, 1, 2


class Order(NamedTuple):
    """The order in which the plain version adds each ``fx x fy`` patch:
    ``form`` MEAN (``box_mean``'s running sum), MEAN_PAIRS (its 2 x 2 patch
    on a power-of-two width) or PRODUCTS (past 4096: ``n_a`` partial sums
    over the x offsets, then ``n_b`` over the y offsets)."""
    fx: int
    fy: int
    form: int
    n_a: int
    n_b: int


def downsample_order(shape, dimout: Tuple[int, int]) -> Order:
    """The plain version's order for an input of ``shape [..., nx, ny]``: a
    function of the shape alone (``resample.box_mean``,
    ``resample.box_product_accumulators``)."""
    nx_in, ny_in = shape[-2], shape[-1]
    nx_out, ny_out = dimout
    if nx_out > nx_in or ny_out > ny_in:
        raise ValueError("downsample target must not exceed source dims")
    fx, fy = nx_in // nx_out, ny_in // ny_out
    if nx_in <= 4096 and ny_in <= 4096:
        ny = ny_out * fy  # box_mean's width: the cropped grid's
        pairs = fx == fy == 2 and ny & (ny - 1) == 0
        return Order(fx, fy, MEAN_PAIRS if pairs else MEAN, 1, 1)
    n_a, n_b = resample.box_product_accumulators(shape, ny_out)
    return Order(fx, fy, PRODUCTS, n_a, n_b)


def downsample_factors(order: Order):
    """``(sx, sy, inv)``: ``1/fx`` and ``1/fy`` rounded to float32 as the
    plain version's product with a Python float rounds them, and ``1/(fx
    fy)`` as PyTorch forms the reciprocal when it divides a CUDA tensor by a
    host scalar (float32 ``1 / n``; the CPU divides, the same for every
    power-of-two patch)."""
    n = np.float32(order.fx * order.fy)
    return (_build.f32(1.0 / order.fx), _build.f32(1.0 / order.fy),
            float(np.float32(1.0) / n))


def motion_ratios(dimin: Tuple[int, int], dimout: Tuple[int, int]):
    """``(sx, sy)``: each component's scale ``n_out / n_in``, rounded to
    float32 as ``resample._motion_ratio``'s ``torch.tensor`` rounds it."""
    (nx_in, ny_in), (nx_out, ny_out) = dimin, dimout
    return _build.f32(nx_out / nx_in), _build.f32(ny_out / ny_in)


def kernel_args(shape, dimout: Tuple[int, int], scales=(1.0, 1.0)) -> tuple:
    """The arguments ``of2d_downsample`` takes after its two pointers, for an
    input of ``shape [..., nx, ny]``: planes, the sizes, the order, the
    host-rounded factors and the scale of plane 0 and of the others."""
    order = downsample_order(shape, dimout)
    planes = math.prod(shape[:-2])
    return (planes, shape[-2], shape[-1], *dimout, *order, *downsample_factors(order),
            *scales)


def downsample_image_ref(image: torch.Tensor, dimout: Tuple[int, int]) -> torch.Tensor:
    """Plain PyTorch version of the kernel, in ``downsample_order``'s order
    (``resample.downsample_image`` says why this order)."""
    fx, fy, form, n_a, n_b = downsample_order(image.shape, dimout)
    nx_out, ny_out = dimout
    cropped = image[..., : nx_out * fx, : ny_out * fy]
    if form != PRODUCTS:
        return resample.box_mean(cropped, fx, fy)
    sx, sy = 1.0 / fx, 1.0 / fy
    c = [[cropped[..., a::fx, b::fy] for b in range(fy)] for a in range(fx)]
    cols = [resample._interleaved([c[a][b] * sx for a in range(fx)], n_a) for b in range(fy)]
    return resample._interleaved([col * sy for col in cols], n_b)


def downsample_motion_ref(u: torch.Tensor, dimout: Tuple[int, int]) -> torch.Tensor:
    """Plain PyTorch version of the kernel on a motion field: the
    downsample, then each component times its axis' size ratio."""
    return downsample_image_ref(u, dimout) * resample._motion_ratio(u, dimout)


def _launch(x: torch.Tensor, dimout: Tuple[int, int], scales) -> torch.Tensor:
    if x.device.type != "cuda":
        raise ValueError(f"no downsample for device {x.device}")
    if x.dim() < 2:
        raise ValueError(f"the input must be [..., nx, ny], got {tuple(x.shape)}")
    _build.check_cuda("the input", x, x.shape, x.device)
    args = kernel_args(tuple(x.shape), dimout, scales)
    out = torch.empty(tuple(x.shape[:-2]) + tuple(dimout), dtype=x.dtype, device=x.device)
    _build.launch("of2d_downsample", x.device, x.data_ptr(), out.data_ptr(), *args)
    kernels.LAUNCHES["downsample"] += 1
    return out


def downsample_image(image: torch.Tensor, dimout: Tuple[int, int]) -> torch.Tensor:
    """Box-filter downsample ``[..., nx, ny] -> [..., *dimout]``; the plain
    version on the CPU, the kernel on CUDA."""
    if _build.on_cpu(image):
        return downsample_image_ref(image, dimout)
    return _launch(image, dimout, (1.0, 1.0))


def downsample_motion(u: torch.Tensor, dimout: Tuple[int, int]) -> torch.Tensor:
    """Downsample ``u [2, nx, ny]`` to ``[2, *dimout]``, each component
    scaled by its axis' size ratio; the plain version on the CPU, the kernel
    on CUDA."""
    if _build.on_cpu(u):
        return downsample_motion_ref(u, dimout)
    if u.dim() != 3 or u.shape[0] != 2:
        raise ValueError(f"u must be [2, nx, ny], got {tuple(u.shape)}")
    return _launch(u, dimout, motion_ratios(tuple(u.shape[-2:]), dimout))
