"""Share of the traced window in which no device operation ran:
``100 (1 - busy / window)``, busy the union of the operations' intervals."""

from torch_bench import trace


def read(p: trace.Profile):
    window = p.window[1] - p.window[0]
    if window <= 0 or not p.device:
        return None
    return 100.0 * (1.0 - trace.busy_seconds(p) / window)
