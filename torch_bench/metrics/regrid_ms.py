"""Wall time of the fluid loop's regrids a request: the durations of the
program's ``regrid`` spans (a compose, the warp and the derivatives again)
that open inside the traced window, over the traced requests, in ms. Where
the traced solves report regrids and the program recorded no ``regrid``
span, the program has none, and the reader finds nothing."""

from torch_bench import program_spans, trace


def read(p: trace.Profile):
    if program_spans.load(p) is None or not p.solves:
        return None
    w0, w1 = p.window
    durations = [r[2] for r in program_spans.program_records()[0]
                 if r[0] == "regrid" and r[2] is not None and w0 <= r[1] <= w1]
    if not durations and any(rg for request in p.solves for _, _, rg in request):
        return None
    return 1e3 * sum(durations) / len(p.solves)
