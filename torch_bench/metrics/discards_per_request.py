"""Blocks the level loop launched ahead and then dropped, a request: the
program's ``discard`` spans (one for each block launched before the stop
decision of the block ahead of it and dropped because the stop landed
there) that open inside the traced window, over the traced requests. 0
where the program records its spans but no ``discard`` (a level loop
without the lookahead)."""

from torch_bench import program_spans, trace


def read(p: trace.Profile):
    spans = program_spans.load(p)
    if spans is None or not p.solves:
        return None
    return spans.count("discard", p.window) / len(p.solves)
