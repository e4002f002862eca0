"""Bilinear backward warp and motion composition by direct gather (CUDA
``csrc/warp_gather.cu``, the counterpart of
``opticalflow2d_tpu/pallas_kernels/warp_fused.py``).

Semantics of the reference (``src/Image.cpp:119-182``,
``src/Motion.cpp:113-178``): a sample whose floor corner lies outside the
grid passes through; the ``(dx+1)`` and ``(dy+1)`` taps count only inside
the grid, and the sum is renormalized by the included weight. The four taps
are read at clamped indices, which is exact for any displacement, so unlike
the TPU kernel there is no halo bound.
"""

from __future__ import annotations

import torch

from opticalflow2d_tpu_torch import kernels
from opticalflow2d_tpu_torch.kernels import _build


def bilinear(data: torch.Tensor, px: torch.Tensor, py: torch.Tensor):
    """Bilinear samples of ``data [C, nx, ny]`` at ``(px, py)`` (any 2D
    grid): ``(value [C, ...], weight, in_bounds)`` before renormalization,
    with the reference's tap inclusion (``src/Image.cpp:155-173``)."""
    nx, ny = data.shape[-2], data.shape[-1]
    dxf = torch.floor(px)
    dyf = torch.floor(py)
    fx = px - dxf
    fy = py - dyf
    dx = dxf.to(torch.int64)
    dy = dyf.to(torch.int64)
    in_bounds = (dx >= 0) & (dx < nx) & (dy >= 0) & (dy < ny)
    has_x1 = dx < nx - 1
    has_y1 = dy < ny - 1
    w00 = (1.0 - fx) * (1.0 - fy)
    w10 = torch.where(has_x1, fx * (1.0 - fy), 0.0)
    w01 = torch.where(has_y1, (1.0 - fx) * fy, 0.0)
    w11 = torch.where(has_x1 & has_y1, fx * fy, 0.0)
    x0, x1 = dx.clamp(0, nx - 1), (dx + 1).clamp(0, nx - 1)
    y0, y1 = dy.clamp(0, ny - 1), (dy + 1).clamp(0, ny - 1)
    value = (data[..., x0, y0] * w00 + data[..., x1, y0] * w10
             + data[..., x0, y1] * w01 + data[..., x1, y1] * w11)
    weight = w00 + w10 + w01 + w11
    return value, weight, in_bounds


def _sample_coords(u: torch.Tensor):
    nx, ny = u.shape[-2], u.shape[-1]
    gi = torch.arange(nx, dtype=u.dtype, device=u.device)[:, None]
    gj = torch.arange(ny, dtype=u.dtype, device=u.device)[None, :]
    return gi + u[0], gj + u[1]


def warp2d_ref(image: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the warp kernel."""
    px, py = _sample_coords(u)
    value, weight, in_bounds = bilinear(image[None], px, py)
    ok = in_bounds & (weight != 0)
    return torch.where(ok, value[0] / torch.where(weight != 0, weight, 1.0), image)


def compose_ref(u_total: torch.Tensor, u_inc: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the compose kernel."""
    px, py = _sample_coords(u_inc)
    value, weight, in_bounds = bilinear(u_total, px, py)
    warped = value / torch.where(weight != 0, weight, 1.0)
    # In bounds: the increment plus the warped total (the increment alone
    # where the weight vanishes); out of bounds: the old total.
    inc_plus = u_inc + torch.where(weight != 0, warped, 0.0)
    return torch.where(in_bounds[None], inc_plus, u_total)


def _launch(entry: str, name: str, data: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    if u.device.type != "cuda":
        raise ValueError(f"no {name} for device {u.device}")
    _, nx, ny = u.shape
    _build.check_cuda("u", u, (2, nx, ny), u.device)
    _build.check_cuda("data", data, data.shape[:-2] + (nx, ny), u.device)
    out = torch.empty_like(data)
    _build.launch(entry, u.device, data.data_ptr(), u.data_ptr(), out.data_ptr(), nx, ny)
    kernels.LAUNCHES[name] += 1
    return out


def warp2d(image: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Backward-warp ``image [nx, ny]`` by ``u [2, nx, ny]``:
    ``out(x) = I(x + u(x))``; the plain version on the CPU, the kernel on
    CUDA."""
    if _build.on_cpu(image, u):
        return warp2d_ref(image, u)
    if image.dim() != 2:
        raise ValueError(f"image must be [nx, ny], got {tuple(image.shape)}")
    return _launch("of2d_warp2d", "warp2d", image, u)


def compose(u_total: torch.Tensor, u_inc: torch.Tensor) -> torch.Tensor:
    """Motion composition ``u_inc + u_total(x + u_inc)`` of two
    ``[2, nx, ny]`` fields (the reference's ``Motion::accumulate``); the
    plain version on the CPU, the kernel on CUDA."""
    if _build.on_cpu(u_total, u_inc):
        return compose_ref(u_total, u_inc)
    if u_total.dim() != 3 or u_total.shape[0] != 2:
        raise ValueError(f"u_total must be [2, nx, ny], got {tuple(u_total.shape)}")
    return _launch("of2d_compose", "compose", u_total, u_inc)
