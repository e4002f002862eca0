"""Horn-Schunck diffusion solver (PyTorch port of
``opticalflow2d_tpu.solvers.diffusion``).

One Jacobi-style fixed-point iteration
``u <- qbar(u) - f(qbar(u)) / (alpha^2 + |grad I|^2)`` where ``qbar`` is the
4-neighbour average and the force is evaluated at ``qbar(u)`` (reference
``src/regularization/OpticalFlow/OpticalFlowDiffusion.cpp:19-84``). The
registration driver runs the fused forms in ``kernels.diffusion_block`` and
``kernels.diffusion_fused``; this is the plain step in the JAX jnp order.
"""

from __future__ import annotations

import torch

from opticalflow2d_tpu_torch.ops.grid import qlaplacian
from opticalflow2d_tpu_torch.solvers.base import Derivatives, lssd_force


def diffusion_step(u: torch.Tensor, d: Derivatives, alpha: float) -> torch.Tensor:
    """One Horn-Schunck update of the motion estimate ``u [2, nx, ny]``."""
    q = qlaplacian(u)
    f = lssd_force(d, q)
    den = alpha * alpha + d.grad_i[0] ** 2 + d.grad_i[1] ** 2
    return q - f / den[None]
