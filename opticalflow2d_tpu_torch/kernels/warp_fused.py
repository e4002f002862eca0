"""Bilinear backward warp and motion composition by direct gather (CUDA
``csrc/warp_gather.cu``, the counterpart of
``opticalflow2d_tpu/pallas_kernels/warp_fused.py``).

Semantics of the reference (``src/Image.cpp:119-182``,
``src/Motion.cpp:113-178``): a sample whose floor corner lies outside the
grid passes through; the ``(dx+1)`` and ``(dy+1)`` taps count only inside
the grid, and the sum is renormalized by the included weight. The four taps
are read at clamped indices, which is exact for any displacement, so unlike
the TPU kernel there is no halo bound. ``warp2d_batch`` and
``compose_batch`` run the listed pairs of a stack in one launch (the
lockstep batch driver, ``parallel.batch``).
"""

from __future__ import annotations

import torch

from opticalflow2d_tpu_torch import kernels
from opticalflow2d_tpu_torch.kernels import _build


def _weights(px: torch.Tensor, py: torch.Tensor, nx: int, ny: int):
    """The floor corner ``(dx, dy)`` of samples at ``(px, py)`` on an
    ``nx x ny`` grid, their four weights with the reference's tap inclusion
    (``src/Image.cpp:155-173``), the weights' sum and the bounds test."""
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
    return dx, dy, (w00, w10, w01, w11), w00 + w10 + w01 + w11, in_bounds


def bilinear(data: torch.Tensor, px: torch.Tensor, py: torch.Tensor):
    """Bilinear samples of ``data [C, nx, ny]`` at ``(px, py)`` (any 2D
    grid): ``(value [C, ...], weight, in_bounds)`` before renormalization,
    with the reference's tap inclusion (``src/Image.cpp:155-173``)."""
    nx, ny = data.shape[-2], data.shape[-1]
    dx, dy, (w00, w10, w01, w11), weight, in_bounds = _weights(px, py, nx, ny)
    x0, x1 = dx.clamp(0, nx - 1), (dx + 1).clamp(0, nx - 1)
    y0, y1 = dy.clamp(0, ny - 1), (dy + 1).clamp(0, ny - 1)
    value = (data[..., x0, y0] * w00 + data[..., x1, y0] * w10
             + data[..., x0, y1] * w01 + data[..., x1, y1] * w11)
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


def _global_coords(u: torch.Tensor, row0: int):
    """Global sample coordinates of a strip whose first row is ``row0``."""
    nxl, ny = u.shape[-2], u.shape[-1]
    gi = torch.arange(nxl, dtype=u.dtype, device=u.device)[:, None] + row0
    gj = torch.arange(ny, dtype=u.dtype, device=u.device)[None, :]
    return gi + u[0], gj + u[1]


def _bilinear_local(data_pad: torch.Tensor, px: torch.Tensor, py: torch.Tensor, row0: int,
                    nx_glob: int, halo: int):
    """``bilinear`` for a strip of ``nxl`` rows whose first is global row
    ``row0``: ``data_pad [C, nxl + 2 pad, ny]`` carries ``pad`` halo rows a
    side, ``(px, py)`` are global coordinates. Weights and bounds are the
    image's; a sample's taps are read only where both floor offsets lie in
    ``[-halo, halo]`` and are 0 elsewhere (``parallel/spatial.py:262-315``)."""
    nxl, ny = px.shape
    pad = (data_pad.shape[-2] - nxl) // 2
    dx, dy, (w00, w10, w01, w11), weight, in_bounds = _weights(px, py, nx_glob, ny)
    gi = torch.arange(row0, row0 + nxl, device=px.device)[:, None]
    gj = torch.arange(ny, device=px.device)[None, :]
    taps = ((dx - gi).abs() <= halo) & ((dy - gj).abs() <= halo)
    x0 = torch.where(taps, dx - row0 + pad, pad)
    y0, y1 = dy.clamp(0, ny - 1), (dy + 1).clamp(0, ny - 1)

    def tap(x, y):
        return torch.where(taps, data_pad[..., x, y], 0.0)

    value = (tap(x0, y0) * w00 + tap(x0 + 1, y0) * w10
             + tap(x0, y1) * w01 + tap(x0 + 1, y1) * w11)
    return value, weight, in_bounds


def warp2d_strip_ref(image_pad: torch.Tensor, u: torch.Tensor, row0: int, nx_glob: int,
                     halo: int) -> torch.Tensor:
    """Plain PyTorch version of the strip warp (``parallel/spatial.py::
    _warp_local``)."""
    pad = (image_pad.shape[-2] - u.shape[-2]) // 2
    image = image_pad[pad:pad + u.shape[-2]]
    value, weight, in_bounds = _bilinear_local(image_pad[None], *_global_coords(u, row0),
                                               row0, nx_glob, halo)
    ok = in_bounds & (weight != 0)
    return torch.where(ok, value[0] / torch.where(weight != 0, weight, 1.0), image)


def compose_strip_ref(u_total_pad: torch.Tensor, u_inc: torch.Tensor, row0: int, nx_glob: int,
                      halo: int) -> torch.Tensor:
    """Plain PyTorch version of the strip compose (``parallel/spatial.py::
    _compose_local``)."""
    pad = (u_total_pad.shape[-2] - u_inc.shape[-2]) // 2
    u_total = u_total_pad[:, pad:pad + u_inc.shape[-2]]
    value, weight, in_bounds = _bilinear_local(u_total_pad, *_global_coords(u_inc, row0),
                                               row0, nx_glob, halo)
    warped = value / torch.where(weight != 0, weight, 1.0)
    inc_plus = u_inc + torch.where(weight != 0, warped, 0.0)
    return torch.where(in_bounds[None], inc_plus, u_total)


def _launch_strip(entry: str, name: str, data_pad: torch.Tensor, u: torch.Tensor, row0: int,
                  nx_glob: int, halo: int) -> torch.Tensor:
    if u.device.type != "cuda":
        raise ValueError(f"no {name} for device {u.device}")
    _, nxl, ny = u.shape
    pad = (data_pad.shape[-2] - nxl) // 2
    _build.check_cuda("u", u, (2, nxl, ny), u.device)
    _build.check_cuda("data_pad", data_pad, data_pad.shape[:-2] + (nxl + 2 * pad, ny),
                      u.device)
    _build.check_strip(row0, nxl, nx_glob)
    if not 0 <= halo <= pad - 1:
        raise ValueError(f"halo {halo} needs at least {halo + 1} pad rows a side, got {pad}")
    out = torch.empty(data_pad.shape[:-2] + (nxl, ny), dtype=u.dtype, device=u.device)
    _build.launch(entry, u.device, data_pad.data_ptr(), u.data_ptr(), out.data_ptr(), nxl, ny,
                  pad, row0, nx_glob, halo)
    kernels.LAUNCHES[name] += 1
    return out


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


def warp2d_strip(image_pad: torch.Tensor, u: torch.Tensor, row0: int, nx_glob: int,
                 halo: int) -> torch.Tensor:
    """Backward-warp one strip: ``image_pad [nxl + 2 pad, ny]`` carries
    ``pad >= halo + 1`` halo rows a side (zeros beyond the image), ``u [2,
    nxl, ny]`` is the strip's motion, ``row0`` the global index of its first
    row and ``nx_glob`` the image's rows. ``pad`` is taken from the shapes.
    The plain version on the CPU, the kernel on CUDA."""
    if _build.on_cpu(image_pad, u):
        return warp2d_strip_ref(image_pad, u, row0, nx_glob, halo)
    if image_pad.dim() != 2:
        raise ValueError(f"image_pad must be [rows, ny], got {tuple(image_pad.shape)}")
    return _launch_strip("of2d_warp2d_strip", "warp2d_strip", image_pad, u, row0, nx_glob,
                         halo)


def compose_strip(u_total_pad: torch.Tensor, u_inc: torch.Tensor, row0: int, nx_glob: int,
                  halo: int) -> torch.Tensor:
    """Compose one strip: ``u_total_pad [2, nxl + 2 pad, ny]`` with halo
    rows as for ``warp2d_strip``, ``u_inc [2, nxl, ny]``. The plain version
    on the CPU, the kernel on CUDA."""
    if _build.on_cpu(u_total_pad, u_inc):
        return compose_strip_ref(u_total_pad, u_inc, row0, nx_glob, halo)
    if u_total_pad.dim() != 3 or u_total_pad.shape[0] != 2:
        raise ValueError(f"u_total_pad must be [2, rows, ny], got {tuple(u_total_pad.shape)}")
    return _launch_strip("of2d_compose_strip", "compose_strip", u_total_pad, u_inc, row0,
                         nx_glob, halo)


def warp2d_batch_ref(images: torch.Tensor, u: torch.Tensor, pairs,
                     out: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch version of the batched warp: ``warp2d_ref`` on each
    listed pair, into ``out[p]``."""
    pairs = _build.as_pairs(pairs, u.shape[0])
    out = torch.zeros_like(images) if out is None else out
    for p in pairs:
        out[p] = warp2d_ref(images[p], u[p])
    return out


def compose_batch_ref(u_total: torch.Tensor, u_inc: torch.Tensor, pairs,
                      out: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch version of the batched compose: ``compose_ref`` on
    each listed pair, into ``out[p]``."""
    pairs = _build.as_pairs(pairs, u_inc.shape[0])
    out = torch.zeros_like(u_total) if out is None else out
    for p in pairs:
        out[p] = compose_ref(u_total[p], u_inc[p])
    return out


def _launch_batch(entry: str, name: str, data: torch.Tensor, u: torch.Tensor, pairs,
                  out) -> torch.Tensor:
    if u.device.type != "cuda":
        raise ValueError(f"no {name} for device {u.device}")
    if u.dim() != 4 or u.shape[1] != 2:
        raise ValueError(f"u must be [B, 2, nx, ny], got {tuple(u.shape)}")
    b, _, nx, ny = u.shape
    _build.check_cuda("u", u, (b, 2, nx, ny), u.device)
    _build.check_cuda("data", data, data.shape[:-2] + (nx, ny), u.device)
    if data.shape[0] != b:
        raise ValueError(f"data holds {data.shape[0]} pairs, u {b}")
    pairs = _build.as_pairs(pairs, b)
    if out is None:
        out = torch.zeros_like(data)
    _build.check_out(out, data, data, u)
    _build.launch(entry, u.device, data.data_ptr(), u.data_ptr(), out.data_ptr(),
                  pairs.on(u.device).data_ptr(), len(pairs), nx, ny)
    kernels.LAUNCHES[name] += 1
    return out


def warp2d_batch(images: torch.Tensor, u: torch.Tensor, pairs,
                 out: torch.Tensor | None = None) -> torch.Tensor:
    """``warp2d`` of the listed pairs of a stack in one launch: ``images
    [B, nx, ny]``, ``u [B, 2, nx, ny]``, ``pairs`` distinct indices in
    ``[0, B)``. Writes pair ``p``'s warp into ``out[p]`` and leaves the
    other pairs of ``out`` as they are (zeros when ``out`` is None); each
    equals its own ``warp2d`` call's. The plain version on the CPU, the
    kernel on CUDA."""
    if _build.on_cpu(images, u, *(() if out is None else (out,))):
        return warp2d_batch_ref(images, u, pairs, out)
    if images.dim() != 3:
        raise ValueError(f"images must be [B, nx, ny], got {tuple(images.shape)}")
    return _launch_batch("of2d_warp2d_batch", "warp2d_batch", images, u, pairs, out)


def compose_batch(u_total: torch.Tensor, u_inc: torch.Tensor, pairs,
                  out: torch.Tensor | None = None) -> torch.Tensor:
    """``compose`` of the listed pairs of two ``[B, 2, nx, ny]`` stacks in
    one launch, into ``out[p]`` as ``warp2d_batch`` writes. The plain
    version on the CPU, the kernel on CUDA."""
    if _build.on_cpu(u_total, u_inc, *(() if out is None else (out,))):
        return compose_batch_ref(u_total, u_inc, pairs, out)
    if u_total.dim() != 4 or u_total.shape[1] != 2:
        raise ValueError(f"u_total must be [B, 2, nx, ny], got {tuple(u_total.shape)}")
    return _launch_batch("of2d_compose_batch", "compose_batch", u_total, u_inc, pairs, out)
