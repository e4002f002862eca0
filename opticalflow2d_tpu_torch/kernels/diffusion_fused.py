"""One fused Horn-Schunck diffusion step: zero-border quasi-laplacian, L-SSD
force and Jacobi update in one pass (CUDA ``csrc/diffusion_step.cu``, the
counterpart of ``opticalflow2d_tpu/pallas_kernels/diffusion_fused.py``).

The registration driver runs ``diffusion_step_batch`` to recompute, for the
listed pairs of a stack in one launch, the taken steps of a block in which
the Logger stop fired (``engine.registration._solve_level_blocked``).
"""

from __future__ import annotations

import torch

from opticalflow2d_tpu_torch import kernels
from opticalflow2d_tpu_torch.kernels import _build


def diffusion_step_ref(u: torch.Tensor, grad_i: torch.Tensor, it: torch.Tensor,
                       alpha: float, row0: int = 0, nx_glob: int | None = None) -> torch.Tensor:
    """Plain PyTorch version of the kernel, in the kernel's order of
    operations: ``q = (up + down + (left + right)) * 0.25``, zero on the
    border. ``solvers.diffusion.diffusion_step`` sums the four neighbours
    left to right instead; the two differ by about an ulp.

    ``row0``/``nx_glob``: ``u`` holds rows ``row0..`` of an image of
    ``nx_glob`` rows (a strip with its halo rows), and ``q`` is also zero on
    the image's first and last rows; the strip's own first and last rows
    take no neighbours from beyond it."""
    q = torch.zeros_like(u)
    q[:, 1:-1, 1:-1] = (
        u[:, :-2, 1:-1] + u[:, 2:, 1:-1] + (u[:, 1:-1, :-2] + u[:, 1:-1, 2:])
    ) * 0.25
    if nx_glob is not None:
        gi = torch.arange(row0, row0 + u.shape[1], device=u.device)[:, None]
        q = torch.where((gi == 0) | (gi == nx_glob - 1), 0.0, q)
    gx, gy = grad_i[0], grad_i[1]
    inner = it + q[0] * gx + q[1] * gy
    den = _build.f32(alpha * alpha) + gx * gx + gy * gy
    scale = inner / den
    return torch.stack([q[0] - gx * scale, q[1] - gy * scale])


def diffusion_step_fused(u: torch.Tensor, grad_i: torch.Tensor, it: torch.Tensor,
                         alpha: float) -> torch.Tensor:
    """One diffusion step of ``u [2, nx, ny]`` with ``grad_i [2, nx, ny]``
    and ``it [nx, ny]``: the plain version on the CPU, the kernel on CUDA."""
    if _build.on_cpu(u, grad_i, it):
        return diffusion_step_ref(u, grad_i, it, alpha)
    if u.device.type != "cuda":
        raise ValueError(f"no diffusion step for device {u.device}")
    _, nx, ny = u.shape
    for name, t, shape in (("u", u, (2, nx, ny)), ("grad_i", grad_i, (2, nx, ny)),
                           ("it", it, (nx, ny))):
        _build.check_cuda(name, t, shape, u.device)
    out = torch.empty_like(u)
    _build.launch(
        "of2d_diffusion_step", u.device, u.data_ptr(), grad_i[0].data_ptr(),
        grad_i[1].data_ptr(), it.data_ptr(), out.data_ptr(), nx, ny,
        _build.f32(alpha * alpha),
    )
    kernels.LAUNCHES["diffusion_step"] += 1
    return out


def diffusion_step_batch_ref(u: torch.Tensor, g: torch.Tensor, alpha: float, pairs,
                             out: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch version of the batched kernel: ``diffusion_step_ref``
    on each listed pair, into ``out[p]``."""
    pairs = _build.as_pairs(pairs, u.shape[0])
    out = torch.zeros_like(u) if out is None else out
    for p in pairs:
        out[p] = diffusion_step_ref(u[p], g[p, :2], g[p, 2], alpha)
    return out


def diffusion_step_batch(u: torch.Tensor, g: torch.Tensor, alpha: float, pairs,
                         out: torch.Tensor | None = None) -> torch.Tensor:
    """One diffusion step of the listed pairs of a stack in one launch:
    ``u [B, 2, nx, ny]``, ``g [B, 3, nx, ny]`` (gx, gy, It), ``pairs``
    distinct indices in ``[0, B)``. Writes pair ``p``'s step into
    ``out[p]`` and leaves the other pairs of ``out`` as they are (zeros
    when ``out`` is None); each equals its own ``diffusion_step_fused``
    call's. The plain version on the CPU, the kernel on CUDA."""
    if _build.on_cpu(u, g, *(() if out is None else (out,))):
        return diffusion_step_batch_ref(u, g, alpha, pairs, out)
    if u.device.type != "cuda":
        raise ValueError(f"no diffusion step for device {u.device}")
    if u.dim() != 4 or u.shape[1] != 2:
        raise ValueError(f"u must be [B, 2, nx, ny], got {tuple(u.shape)}")
    b, _, nx, ny = u.shape
    _build.check_cuda("u", u, (b, 2, nx, ny), u.device)
    _build.check_cuda("g", g, (b, 3, nx, ny), u.device)
    pairs = _build.as_pairs(pairs, b)
    if out is None:
        out = torch.zeros_like(u)
    _build.check_out(out, u, u, g)
    _build.launch(
        "of2d_diffusion_step_batch", u.device, u.data_ptr(), g.data_ptr(), out.data_ptr(),
        pairs.on(u.device).data_ptr(), len(pairs), nx, ny, _build.f32(alpha * alpha),
    )
    kernels.LAUNCHES["diffusion_step_batch"] += 1
    return out
