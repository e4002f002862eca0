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


def plain_solve_level_blocked(u, iref, imov, cfg, niter, scale, k, block_fn, recompute_fn):
    """The blocked level loop without its lookahead, the reference its
    tests hold ``engine.registration._solve_level_blocked`` to: launch a
    block, read its Logger sums at once, decide, launch the next. Same
    arguments and result; no spans, no counters."""
    from opticalflow2d_tpu_torch.engine.registration import LevelTrace
    from opticalflow2d_tpu_torch.kernels.derive import derive
    from opticalflow2d_tpu_torch.ops.warp import compose, warp2d

    tol = np.float32(cfg.convergence_tol)
    traces = []
    for _ in range(cfg.nrefine):
        g = derive(iref, warp2d(imov, u))
        u_est = torch.zeros_like(u)
        errs = np.zeros(-(-niter // k) * k, np.float32)
        it, conv = 0, False
        while it < niter and not conv:
            u_blk, sums = block_fn(u_est, g)
            s = sums.cpu().numpy()
            prev = s[:, 1]
            errs_blk = np.where(prev == 0, np.float32(0),
                                s[:, 0] / np.where(prev == 0, np.float32(1), prev))
            its = it + np.arange(k)
            conv_vec = (errs_blk < tol) & (its > 1) & (its < niter)
            conv = bool(conv_vec.any())
            n_take = int(np.argmax(conv_vec)) + 1 if conv else min(niter - it, k)
            u_est = recompute_fn(u_est, g, n_take) if n_take < k else u_blk
            errs[it:it + n_take] = errs_blk[:n_take]
            it += n_take
        u = compose(u, u_est)
        traces.append(LevelTrace(scale, torch.from_numpy(errs[:niter].copy()), it, 0))
    return u, traces
