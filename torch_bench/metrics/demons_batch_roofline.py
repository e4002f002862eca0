"""The lockstep demons driver's pair-axis B10's share of its roofline: the
least time of its launches (``rooflines/demons_onepass.py``: 24 B/px each
pair-iteration the solves report, over the published HBM bandwidth) over
the device time of the pair-axis B10 kernel and of the reduction of its
Logger partials in the trace. The card's power limit is printed beside it.
Where the trace holds no pair-axis B10 (a program without it, or a map) it
finds nothing."""

from torch_bench import trace
from torch_bench.rooflines import demons_onepass

BATCH_KERNEL = "demons_onepass_batch_kernel"
# The pair-axis B10 and the kernel that adds its partials, one group a pair.
KERNELS = (BATCH_KERNEL, "sum_partials_kernel")


def read(p: trace.Profile):
    if not any(kind == "kernel" and trace.kernel_base(name) == BATCH_KERNEL
               for name, _, _, kind in p.device):
        return None
    t = sum(d for name, _, d, kind in p.device
            if kind == "kernel" and trace.kernel_base(name) in KERNELS)
    solves = [s for request in p.solves for s in request]
    least = demons_onepass.least_seconds(solves, p.dims, p.nscales, p.peaks["hbm_bytes_per_s"])
    return 100.0 * least / t
