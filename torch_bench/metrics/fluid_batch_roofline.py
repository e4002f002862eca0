"""The lockstep fluid driver's pair-axis kernels' share of their roofline:
the least time of their launches (``rooflines/fluid_iter.py``, unchanged:
each pair-iteration the solves report, B7 at 44 B/px and B5 at 16 B/px,
over the published HBM bandwidth) over the device time of the pair-axis B7
and B5 kernels and their partials' reductions in the trace. The card's
power limit is printed beside it. Where the trace holds none of those
kernels (a program without the pair axes) it finds nothing."""

from torch_bench import trace
from torch_bench.rooflines import fluid_iter

# B7 batched and the reduction of its per-tile maxima (one group a pair),
# B5 batched and the reduction of its partials.
KERNELS = ("fluid_iter_batch_kernel", "max_partials_kernel", "fluid_metrics_batch_kernel",
           "fluid_metrics_reduce_kernel")


def read(p: trace.Profile):
    if not any(kind == "kernel" and trace.kernel_base(name) == "fluid_iter_batch_kernel"
               for name, _, _, kind in p.device):
        return None
    t = sum(d for name, _, d, kind in p.device
            if kind == "kernel" and trace.kernel_base(name) in KERNELS)
    solves = [s for request in p.solves for s in request]
    least = fluid_iter.least_seconds(solves, p.dims, p.nscales, p.peaks["hbm_bytes_per_s"])
    return 100.0 * least / t
