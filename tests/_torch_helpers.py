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
