"""Solver primitives and steps (PyTorch)."""
