"""Pairs one host read of the lockstep demons loop serves: the iterations of
the traced requests' solves, summed over every pair and solve, over the
program's ``read`` spans of ``site="demons_batch"`` that open in the
window. The loop reads once an iteration for all the pairs still
iterating, so this is the mean number of pairs a read serves: up to the
stack's size, falling as pairs stop. Where the program records no such
span (a program without the lockstep demons loop, or a map, whose reads
are ``site="demons"``) it finds nothing."""

from torch_bench import program_spans, trace

SITE = "demons_batch"


def read(p: trace.Profile):
    if program_spans.load(p) is None or not p.solves:
        return None
    records, _ = program_spans.program_records()
    w0, w1 = p.window
    reads = sum(1 for r in records
                if r[0] == "read" and w0 <= r[1] <= w1 and (r[5] or {}).get("site") == SITE)
    if not reads:
        return None
    return trace.iterations(p) / reads
