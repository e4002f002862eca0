"""Solver primitives and steps (PyTorch)."""

from opticalflow2d_tpu_torch.solvers.curvature import make_curvature_step

__all__ = ["make_curvature_step"]
