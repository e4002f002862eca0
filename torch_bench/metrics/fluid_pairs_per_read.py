"""Pairs one host read of the fluid level loops serves: the iterations of
the traced requests' solves, summed over every pair and solve, over the
program's ``read`` spans in the window. The fluid loops read once an
iteration, so this is the mean number of pairs still iterating at a read:
1.0 where each pair runs its own loop (``register_batch``'s map), up to the
stack's size in lockstep, falling as pairs stop. (``pairs_per_read``
divides by ``block_k`` for the blocked loops, which read once a block.)"""

from torch_bench import program_spans, trace


def read(p: trace.Profile):
    spans = program_spans.load(p)
    if spans is None or not p.solves:
        return None
    reads = spans.count("read", p.window)
    if not reads:
        return None
    return trace.iterations(p) / reads
