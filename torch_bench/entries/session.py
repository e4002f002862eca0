"""The session entry: one ``OpticalFlow2d`` for the run, as the upstream
demo holds its MEX object (``test_opticalflow2d.m:40-58``), and per
request ``register`` -> ``get_motion`` -> ``warp`` of the moving image."""

from __future__ import annotations

import torch
from torch.profiler import record_function

from opticalflow2d_tpu_torch import Method, OpticalFlow2d


class Client:
    """Serves one pair a request through the port's public session API."""

    def __init__(self, config: dict, device: torch.device):
        s = config["settings"]
        self.session = OpticalFlow2d(tuple(config["dims"]), s["niter"], s["nscales"],
                                     Method[s["regularisation"]], s["regparams"],
                                     nrefine=s["nrefine"], device=device)
        self.block_k = self.session.config.block_k

    def request(self, iref: torch.Tensor, imov: torch.Tensor):
        """``(motion [2, nx, ny], warped [nx, ny], solves)``, where
        ``solves`` lists ``(scale, iterations, regrids)`` of each level
        and refinement, coarse to fine."""
        with record_function("bench.register"):
            result = self.session.register(iref, imov)
        with record_function("bench.get_motion"):
            motion = self.session.get_motion()
        with record_function("bench.warp"):
            warped = self.session.warp(imov)
        solves = [(int(t.scale), int(t.iterations), int(t.regrids)) for t in result.traces]
        return motion.movedim(-1, 0), warped, solves

    def close(self) -> None:
        self.session.close()
