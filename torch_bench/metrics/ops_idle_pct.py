"""Share of the traced window in which the device is idle while the plain
tensor operations around the solves run: the innermost program span is
``pyramid`` (the images' box downsamples), ``seed`` (a level's motion
downsample), ``derive`` (warp and derivatives of a refinement or a
regrid), ``compose`` or ``upsample`` (the level's motion to full size)."""

from torch_bench import program_spans, trace


def read(p: trace.Profile):
    return program_spans.idle_pct(p, program_spans.OPS)
