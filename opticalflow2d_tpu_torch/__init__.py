"""PyTorch and CUDA port of tpuflow2d: 2D deformable image registration.

The port of ``opticalflow2d_tpu`` (the JAX package, kept as the reference).
Images are ``f32[nx, ny]`` tensors and motion fields ``f32[2, nx, ny]``, as
there: axis 0 is the reference's "x", channel 0 the displacement along it.
The entry points (``register``, ``OpticalFlow2d``) run on the GPU unless
the caller passes ``device="cpu"``; without a CUDA device they raise. On
CUDA the hand-written kernels (``opticalflow2d_tpu_torch.kernels``) carry
the run; on the CPU their plain PyTorch versions do; the spectral solvers
are cuBLAS matmuls and cuFFT transforms at full float32. Ported: the
diffusion (Horn-Schunck), curvature, Thirion and diffeomorphic demons,
elastic and viscous-fluid registrations (SOR, periodic FFT or Dirichlet
DST-I Navier-Lame solves), ``register_phased``, the JAX API's huge-grid
entry point, and ``parallel``: the mesh, batched registration over its data
axis (``register_batch``: the lockstep driver for diffusion, curvature and
elastic, each pair in turn for every family), the strip-parallel drivers
of every family (``make_register_sp`` and its level, step, sweep and
transform factories), one process over the strips' devices, and the
multi-process launcher; and ``utils``: checkpoint and resume
(``register_resumable``), the health checks and the profiling helpers.
"""

from opticalflow2d_tpu_torch.config import (
    CompatFlags,
    Method,
    MotionAccumulation,
    RegConfig,
)
from opticalflow2d_tpu_torch.engine.registration import (
    RegistrationResult,
    register,
    register_phased,
)
from opticalflow2d_tpu_torch.engine.session import OpticalFlow2d

__all__ = [
    "Method",
    "MotionAccumulation",
    "CompatFlags",
    "RegConfig",
    "register",
    "register_phased",
    "RegistrationResult",
    "OpticalFlow2d",
]
