"""Distributed 2D DCT and the strip-parallel curvature step (PyTorch port
of ``opticalflow2d_tpu.parallel.dct_dist``).

Cut into strips along x, the transform is a matmul along the whole y axis
on each strip, a transpose across strips (JAX's ``all_to_all``,
``spatial._all_to_all`` here), and a matmul along the now whole x axis.
The curvature update ``u <- idct2(eig * dct2(u - tau f)) / (4 nx ny)``
needs two transposes: forward-y, transpose, forward-x, eigenvalue
multiply, inverse-x, transpose back, inverse-y. The matmuls are float32
(cuBLAS with TF32 off on the GPU); JAX's ``precision`` (an MXU tier) has no
counterpart.
"""

from __future__ import annotations

import torch

from opticalflow2d_tpu_torch.ops.dct import dct_matrix, full_f32
from opticalflow2d_tpu_torch.parallel.mesh import Mesh
from opticalflow2d_tpu_torch.parallel.spatial import (
    _all_to_all,
    _curvature_solver_strip,
    _curvature_step_strip,
    _gather,
    _split,
    _strip_devices,
)


def _check_dims(devices, nx: int, ny: int) -> None:
    if nx % len(devices) or ny % len(devices):
        raise ValueError(
            f"nx ({nx}) and ny ({ny}) must be divisible by the x-axis size {len(devices)}")


def make_curvature_step_sharded(mesh: Mesh, nx: int, ny: int, alpha: float, tau: float):
    """The curvature update on strips of ``[2, nx, ny]`` fields: ``(u,
    grad_i [2, nx, ny], it [nx, ny]) -> u'``, the serial
    ``solvers.curvature.make_curvature_step`` by the dense transform to the
    matmuls' rounding (the strips take the y transform first)."""
    devices = _strip_devices(mesh)
    _check_dims(devices, nx, ny)
    solve = _curvature_solver_strip(nx, ny, alpha, tau)

    def step(u, grad_i, it_img):
        u, grad_i, it_img = (_split(x, devices) for x in (u, grad_i, it_img))
        return _gather(_curvature_step_strip(u, grad_i, it_img, tau, solve))

    return step


def make_dct2_sharded(mesh: Mesh, nx: int, ny: int, inverse: bool = False):
    """The 2D DCT (FFTW conventions; ``inverse``: REDFT01) of ``[nx, ny]``
    arrays cut into strips along x: ``a -> dct2(a)``."""
    devices = _strip_devices(mesh)
    _check_dims(devices, nx, ny)
    kind = 3 if inverse else 2

    def dct(a):
        with full_f32():
            t = [torch.matmul(x, dct_matrix(ny, kind, x.device).T) for x in _split(a, devices)]
            t = _all_to_all(t, 1, 0)
            t = [torch.matmul(dct_matrix(nx, kind, x.device), x) for x in t]
            return _gather(_all_to_all(t, 0, 1))

    return dct
