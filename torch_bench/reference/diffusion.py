"""Plain reference of Horn-Schunck diffusion registration
(``OpticalFlowDiffusion.cpp:19-84``, the level loop of
``ImageRegistrationOpticalFlow.cpp:97-151``), in float32 PyTorch.

One iteration: ``q`` the 4-neighbour average of ``u`` (zero on the
border, ``gradients.h:72-80``), then ``u <- q - grad I (It + q . grad I) /
(alpha^2 + |grad I|^2)``, until the Logger stops the solve.
"""

from __future__ import annotations

import numpy as np
import torch

from torch_bench.reference import common


def step(u: torch.Tensor, g: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    q = torch.zeros_like(u)
    q[:, 1:-1, 1:-1] = (u[:, :-2, 1:-1] + u[:, 2:, 1:-1]
                        + (u[:, 1:-1, :-2] + u[:, 1:-1, 2:])) * 0.25
    scale = (g[2] + q[0] * g[0] + q[1] * g[1]) / den
    return torch.stack([q[0] - g[0] * scale, q[1] - g[1] * scale])


def register(iref, imov, settings: dict, store=lambda x: x):
    """``(motion [2, nx, ny], [Solve, ...])`` of one pair."""
    alpha = settings["regparams"][0]
    tol = np.float32(settings.get("convergence_tol", 0.001))

    def solve_level(u, iref_s, imov_s, niter, scale):
        solves = []
        for _ in range(settings["nrefine"]):
            g = common.derivatives(iref_s, common.warp(imov_s, u), store)
            den = common.f32(alpha * alpha) + g[0] * g[0] + g[1] * g[1]
            est, it = common.logger_solve(torch.zeros_like(u), lambda v: step(v, g, den),
                                          niter, tol, store)
            u = store(common.compose(u, est))
            solves.append(common.Solve(scale, it, 0))
        return u, solves

    return common.register(iref, imov, settings, solve_level, store)
