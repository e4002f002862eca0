"""Shared helpers of the PyTorch port's tests.

Tier-1 runs six pytest workers on eight cores, so each worker's PyTorch
keeps one intra-op thread. Inputs are made with numpy and handed to both
packages as the same arrays.
"""

import numpy as np
import torch

torch.set_num_threads(1)


def tt(x) -> torch.Tensor:
    """A float32 CPU tensor holding a copy of ``x`` (numpy or JAX array)."""
    return torch.from_numpy(np.array(x, dtype=np.float32))


def npy(x) -> np.ndarray:
    """``x`` (tensor, JAX or numpy array) as a numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def assert_close(got, want, atol: float, rtol: float = 0.0) -> None:
    np.testing.assert_allclose(npy(got), npy(want), rtol=rtol, atol=atol)


def tiled_pair(nx: int, ny: int, shift=(1.5, -0.8), seed: int = 0):
    """``chip_smoke.py::tiled_pair`` on an ``nx x ny`` grid: Gaussian blobs
    of sigma = 6 px on a 32 px grid, amplitudes 0.3-1.0 from ``seed``, the
    moving image shifted by ``shift``. Every pixel lies within 16 px of a
    blob centre along each axis, so no value is subnormal: XLA on the CPU
    flushes subnormals to zero and PyTorch keeps them, so images compared
    across the two packages must have none."""
    sigma, step = 6.0, 32
    cx = np.arange(step // 2, nx, step, dtype=np.float64)
    cy = np.arange(step // 2, ny, step, dtype=np.float64)
    amp = np.random.default_rng(seed).uniform(0.3, 1.0, (len(cx), len(cy)))

    def img(ox, oy):
        gx = np.exp(-((np.arange(nx)[None, :] - ox - cx[:, None]) ** 2) / (2 * sigma ** 2))
        gy = np.exp(-((np.arange(ny)[None, :] - oy - cy[:, None]) ** 2) / (2 * sigma ** 2))
        return (gx.T @ amp @ gy).astype(np.float32)

    return img(0.0, 0.0), img(*shift)
