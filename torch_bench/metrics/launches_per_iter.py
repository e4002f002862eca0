"""Device operations a solver iteration: the kernels, copies and sets the
trace holds over the traced requests, over their iterations (the host's
dispatch work an iteration)."""

from torch_bench import trace


def read(p: trace.Profile):
    its = trace.iterations(p)
    if not its or not p.device:
        return None
    return len(p.device) / its
