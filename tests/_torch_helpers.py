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


# (shape, level) of the pyramid's downsample: the shapes that pin each order
# of ``ops/resample.py`` (``box_mean`` up to 4096; past it each branch of
# ``box_product_accumulators``: x accumulators a = 1, 2 and 4 and y
# accumulators b = 4, 2 and 1), and the extent of the 16384^2 fluid path,
# whose level 2 is a 4x4 patch past 4096 (a 16384^2 grid is too large to
# compare on the CPU).
DOWNSAMPLE_CASES = [
    ((48, 40), 1), ((64, 48), 1), ((64, 48), 2),
    ((256, 256), 1), ((256, 256), 2),
    ((512, 512), 1), ((512, 512), 2),
    ((1024, 64), 1),
    ((8224, 64), 1), ((8224, 64), 2), ((8224, 64), 3),
    ((8224, 32), 1), ((8224, 32), 2), ((8224, 32), 3),
    ((4104, 128), 2), ((4104, 256), 2), ((4104, 256), 3),
    ((16384, 32), 1), ((16384, 32), 2),
    ((16384, 64), 1), ((16384, 64), 2),
]


def plain_solve_level_blocked(u, irefs, imovs, cfg, niter, scale, k, block_fn, recompute_fn,
                              batch=False):
    """The blocked level loop without its lookahead, the reference its
    tests hold ``engine.registration._solve_level_blocked`` to: on a stack
    of pairs in lockstep, launch a block for the active pairs, read their
    Logger sums at once, decide each pair's stop with the Logger's rule
    written out here, keep a stopped pair's field in a stack of its own,
    launch the next. Same arguments and result; no spans, no counters."""
    from opticalflow2d_tpu_torch.engine.registration import LevelTrace
    from opticalflow2d_tpu_torch.kernels._build import Pairs
    from opticalflow2d_tpu_torch.kernels.derive import derive
    from opticalflow2d_tpu_torch.ops.warp import compose, warp2d

    b = u.shape[0]
    tol = np.float32(cfg.convergence_tol)
    traces = []
    for _ in range(cfg.nrefine):
        g = torch.stack([derive(irefs[p], warp2d(imovs[p], u[p])) for p in range(b)])
        cur, final = torch.zeros_like(u), torch.zeros_like(u)
        errs = np.zeros((b, -(-niter // k) * k), np.float32)
        its = np.zeros(b, np.int64)
        active = list(range(b)) if niter > 0 else []
        while active:
            nxt, sums = block_fn(cur, g, Pairs(active, b), None)
            s = sums.cpu().numpy()
            still = []
            for z, p in enumerate(active):
                it, prev = int(its[p]), s[z, :, 1]
                errs_blk = np.where(prev == 0, np.float32(0),
                                    s[z, :, 0] / np.where(prev == 0, np.float32(1), prev))
                t = it + np.arange(k)
                conv_vec = (errs_blk < tol) & (t > 1) & (t < niter)
                conv = bool(conv_vec.any())
                n_take = int(np.argmax(conv_vec)) + 1 if conv else min(niter - it, k)
                errs[p, it:it + n_take] = errs_blk[:n_take]
                its[p] = it + n_take
                if n_take < k:
                    recompute_fn(cur, g, Pairs([p], b), n_take, final, None)
                elif conv or its[p] == niter:
                    final[p] = nxt[p]
                else:
                    still.append(p)
            cur, active = nxt, still
        u = torch.stack([compose(u[p], final[p]) for p in range(b)])
        traces.append(LevelTrace(scale, torch.from_numpy(errs[:, :niter].copy()),
                                 torch.from_numpy(its), torch.zeros(b, dtype=torch.int64),
                                 torch.zeros(b, dtype=torch.int64)))
    return u, traces
