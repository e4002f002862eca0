"""Host time of the entry calls' own code a request: the parts of the
program's ``register``, ``get_motion`` and ``warp`` spans that no span
inside them covers (their self time), summed over the traced window, over
the traced requests, in ms."""

from torch_bench import program_spans, trace


def read(p: trace.Profile):
    spans = program_spans.load(p)
    if spans is None or not p.solves:
        return None
    own = spans.self_seconds(program_spans.ENTRY, p.window)
    return 1e3 * own / len(p.solves)
