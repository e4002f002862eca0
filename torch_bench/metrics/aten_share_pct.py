"""Share of the device's busy time spent in kernels not built from the
program's CUDA sources (PyTorch's own, for the plain tensor operations):
a kernel counts as the program's when its bare name is a function of the
library the process loaded from its checkout."""

from torch_bench import trace


def read(p: trace.Profile):
    if not p.library_kernels:
        return None
    ours = set(p.library_kernels)
    total = sum(d for _, _, d, _ in p.device)
    other = sum(d for name, _, d, kind in p.device
                if kind == "kernel" and trace.kernel_base(name) not in ours)
    return 100.0 * other / total if total > 0 else None
