"""The batch entry: one ``RegConfig`` for the run, and per request a stack
of pairs through ``register_batch`` in lockstep (``impl="vmap"``), then
the moving images warped by the motion in one batched launch (B3)."""

from __future__ import annotations

import torch
from torch.profiler import record_function

from opticalflow2d_tpu_torch import Method, RegConfig
from opticalflow2d_tpu_torch.kernels._build import Pairs
from opticalflow2d_tpu_torch.kernels.warp_fused import warp2d_batch
from opticalflow2d_tpu_torch.parallel import register_batch


class Client:
    """Serves a stack of pairs a request through the port's batch API."""

    def __init__(self, config: dict, device: torch.device):
        s = config["settings"]
        self.config = RegConfig.from_regparams(Method[s["regularisation"]], s["niter"],
                                               s["nscales"], s["regparams"], s["nrefine"])
        self.device = device
        self.block_k = self.config.block_k
        # Every pair of the stack, kept so that its index list reaches the
        # device once and not at every request.
        self.everyone = None

    def request(self, irefs: torch.Tensor, imovs: torch.Tensor):
        """``(motion [P, 2, nx, ny], warped [P, nx, ny], solves)``, where
        ``solves`` lists ``(scale, iterations, regrids)`` pair by pair,
        pair 0 first, each pair's coarse to fine."""
        b = irefs.shape[0]
        with record_function("bench.register"):
            result = register_batch(irefs, imovs, self.config, impl="vmap", device=self.device)
        if self.everyone is None or self.everyone.batch != b:
            self.everyone = Pairs(range(b), b)
        with record_function("bench.warp"):
            warped = warp2d_batch(imovs, result.motion, self.everyone)
        counts = [(int(t.scale), t.iterations.tolist(), t.regrids.tolist())
                  for t in result.traces]
        solves = [(scale, its[i], regrids[i]) for i in range(b) for scale, its, regrids in counts]
        return result.motion, warped, solves

    def close(self) -> None:
        """Nothing outlives a request: the entry holds no session."""
