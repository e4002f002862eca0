"""Finite differences, reductions, resampling and warps (PyTorch)."""
