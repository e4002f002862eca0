"""Host synchronisations a request outside the level loop's reads: the
runtime calls of ``trace.SYNC_CALLS`` that start inside a program
``register`` span but outside every ``read`` span, over the traced
requests. Their count by innermost program span goes to stderr."""

import sys

from torch_bench import program_spans, trace


def read(p: trace.Profile):
    spans = program_spans.load(p)
    if spans is None or not p.solves:
        return None
    by_span = {}
    for name, start, _ in p.runtime:
        if name not in trace.SYNC_CALLS:
            continue
        i = spans.at(start)
        lineage = spans.lineage(i)
        if "register" in lineage and "read" not in lineage:
            by_span[spans.names[i]] = by_span.get(spans.names[i], 0) + 1
    print(f"stray syncs by innermost program span, over {len(p.solves)} requests: {by_span}",
          file=sys.stderr, flush=True)
    return sum(by_span.values()) / len(p.solves)
