"""Share of the traced window in which the device is idle while the level
loop's own code runs: the innermost program span is ``solve`` (the
driver's code between its children: launches, bookkeeping), ``read`` (a
block's one host read and the stop decision after it) or ``recompute``
(the steps of a stop inside a block). The loop's turnaround between
blocks."""

from torch_bench import program_spans, trace


def read(p: trace.Profile):
    return program_spans.idle_pct(p, program_spans.LOOP)
