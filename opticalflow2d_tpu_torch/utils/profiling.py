"""Profiling helpers (PyTorch port of ``opticalflow2d_tpu.utils.profiling``):
a ``torch.profiler`` trace written as a Chrome trace, and a kernel timer
that takes the slope between two loop lengths, so that the fixed cost of a
call (launch, synchronisation) cancels.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
from typing import Callable

import torch

@contextlib.contextmanager
def trace(logdir: str | None = None):
    """Profile the block with ``torch.profiler`` (CPU activity, and CUDA
    activity where a CUDA device is present) and write its Chrome trace
    (``chrome://tracing``, Perfetto) into ``logdir`` when the block ends,
    also when it raises; yields ``logdir``. The default directory is
    ``tpuflow2d-trace`` under the temporary directory."""
    if logdir is None:
        logdir = os.path.join(tempfile.gettempdir(), "tpuflow2d-trace")
    os.makedirs(logdir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield logdir
    finally:
        prof.stop()
        prof.export_chrome_trace(
            os.path.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def _device_of(state) -> torch.device:
    if isinstance(state, torch.Tensor):
        return state.device
    if isinstance(state, dict):
        state = list(state.values())
    if isinstance(state, (tuple, list)):
        for item in state:
            if isinstance(item, (torch.Tensor, tuple, list, dict)):
                return _device_of(item)
    raise TypeError("kernel_timer's state holds no tensor")


def kernel_timer(fn: Callable, state, iters_lo: int = 200, iters_hi: int = 1000,
                 reps: int = 3) -> float:
    """Seconds per iteration of the ``state -> state`` step ``fn``: the
    slope between loops of ``iters_lo`` and ``iters_hi`` steps, each the
    best of ``reps`` runs after one warm-up. On CUDA (the device of the
    first tensor in ``state``) a loop is timed by CUDA events, after a
    synchronisation of the device and up to the end event's completion; on
    the CPU, where every operation returns when done, by ``perf_counter``."""
    if not 0 < iters_lo < iters_hi:
        raise ValueError(f"need 0 < iters_lo < iters_hi, got {iters_lo}, {iters_hi}")
    device = _device_of(state)

    def run(n: int) -> None:
        s = state
        for _ in range(n):
            s = fn(s)

    def timed(n: int) -> float:
        if device.type != "cuda":
            t0 = time.perf_counter()
            run(n)
            return time.perf_counter() - t0
        with torch.cuda.device(device):
            torch.cuda.synchronize(device)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            run(n)
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / 1e3

    def best(n: int) -> float:
        timed(n)  # warm-up
        return min(timed(n) for _ in range(reps))

    t_lo, t_hi = best(iters_lo), best(iters_hi)
    return max(t_hi - t_lo, 1e-12) / (iters_hi - iters_lo)
