"""Auxiliary subsystems of the port: checkpoint and resume, profiling,
numerical-health checks."""

from opticalflow2d_tpu_torch.utils.checkpoint import (
    load_checkpoint,
    load_checkpoint_traces,
    register_resumable,
    save_checkpoint,
)
from opticalflow2d_tpu_torch.utils.health import assert_finite, debug_nans, divergence_guard
from opticalflow2d_tpu_torch.utils.profiling import kernel_timer, trace

__all__ = [
    "save_checkpoint", "load_checkpoint", "load_checkpoint_traces", "register_resumable",
    "trace", "kernel_timer", "debug_nans", "assert_finite", "divergence_guard",
]
