"""Pairs one host read of the level loop serves: the pair-blocks of the
traced requests (over every pair and solve, ``ceil(iterations /
block_k)``, the blocks that pair took part in) over the program's
``read`` spans in the window. The lockstep driver reads once a block for
all its active pairs, so this is the mean number of pairs still iterating
at a read: it falls as pairs stop and leave the lockstep."""

from torch_bench import program_spans, trace


def read(p: trace.Profile):
    spans = program_spans.load(p)
    if spans is None or not p.solves:
        return None
    reads = spans.count("read", p.window)
    if not reads:
        return None
    blocks = sum(-(-it // p.block_k) for request in p.solves for _, it, _ in request)
    return blocks / reads
