"""Bilinear upsample of a motion field in one pass (CUDA ``csrc/upsample.cu``).

The level loop brings each level's motion to full resolution
(``engine/registration.py``): a corner-anchored bilinear upsample with
edge-weight renormalization, each component scaled by the size ratio
(reference ``src/Field.tpp:146-206``, ``src/Motion.cpp:61-85``). No TPU
kernel did this: the JAX package upsamples in jnp
(``opticalflow2d_tpu/ops/resample.py``). The kernel replaces the plain
version's launches and full-size temporaries with one launch that writes
only the output, and rounds its ratios on the host, so it makes no device
tensor from a Python float and does not synchronise.
"""

from __future__ import annotations

from typing import Tuple

import torch

from opticalflow2d_tpu_torch import kernels
from opticalflow2d_tpu_torch.kernels import _build
from opticalflow2d_tpu_torch.ops import resample


def upsample_motion_ref(u: torch.Tensor, dimout: Tuple[int, int]) -> torch.Tensor:
    """Plain PyTorch version of the kernel."""
    return resample.upsample_image(u, dimout) * resample._motion_ratio(u, dimout)


def upsample_ratios(dimin: Tuple[int, int], dimout: Tuple[int, int]):
    """``(rx, ry, sx, sy)``: the coordinate ratios ``n_in / n_out`` and the
    component scales ``n_out / n_in`` of each axis, rounded to float32 as the
    plain version's ``torch.tensor(x, dtype=torch.float32)`` rounds them."""
    (nx_in, ny_in), (nx_out, ny_out) = dimin, dimout
    return (_build.f32(nx_in / nx_out), _build.f32(ny_in / ny_out),
            _build.f32(nx_out / nx_in), _build.f32(ny_out / ny_in))


def upsample_motion(u: torch.Tensor, dimout: Tuple[int, int]) -> torch.Tensor:
    """Upsample ``u [2, nx, ny]`` to ``[2, *dimout]``, each component scaled
    by its axis' size ratio; the plain version on the CPU, the kernel on
    CUDA."""
    if _build.on_cpu(u):
        return upsample_motion_ref(u, dimout)
    if u.device.type != "cuda":
        raise ValueError(f"no upsample_motion for device {u.device}")
    if u.dim() != 3 or u.shape[0] != 2:
        raise ValueError(f"u must be [2, nx, ny], got {tuple(u.shape)}")
    _, nx_in, ny_in = u.shape
    nx_out, ny_out = dimout
    if nx_out < nx_in or ny_out < ny_in:
        raise ValueError("upsample target must not be below source dims")
    _build.check_cuda("u", u, (2, nx_in, ny_in), u.device)
    out = torch.empty((2, nx_out, ny_out), dtype=u.dtype, device=u.device)
    _build.launch("of2d_upsample_motion", u.device, u.data_ptr(), out.data_ptr(), nx_in, ny_in,
                  nx_out, ny_out, *upsample_ratios((nx_in, ny_in), (nx_out, ny_out)))
    kernels.LAUNCHES["upsample_motion"] += 1
    return out
