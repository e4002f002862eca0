"""The fluid iteration's share of its roofline: the least time of its
launches (``rooflines/fluid_iter.py``: B5 and B7, or B5, B8 and B9 past
an extent of 8192, over the published HBM bandwidth) over the device time
their kernels took in the trace. The card's power limit is printed beside
it."""

from torch_bench import trace
from torch_bench.rooflines import fluid_iter


def read(p: trace.Profile):
    t = sum(d for name, _, d, kind in p.device
            if kind == "kernel" and trace.kernel_base(name) in fluid_iter.KERNELS)
    if t <= 0:
        return None
    solves = [s for request in p.solves for s in request]
    least = fluid_iter.least_seconds(solves, p.dims, p.nscales, p.peaks["hbm_bytes_per_s"])
    return 100.0 * least / t
