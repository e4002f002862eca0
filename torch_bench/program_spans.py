"""The program's own spans (``opticalflow2d_tpu_torch.utils.profiling``)
laid over a traced window: which program span was innermost at each
moment, the self time of each span, and the spans above it.

The program records its spans while a ``torch.profiler`` runs, on
``time.time_ns()``, the clock the profiler stamps its events with; a
record is ``[name, start_s, dur_s, parent, request, attrs]``, ``parent``
the index of the span it opened inside (-1 for none). A reader finds
nothing, and returns None, where the program has no recorder (an older
commit), where the window holds no span, or where the recorder dropped
records that may lie inside the window.
"""

from __future__ import annotations

import bisect

from torch_bench import trace

ENTRY = ("register", "get_motion", "warp")
LOOP = ("solve", "read", "recompute")
OPS = ("pyramid", "seed", "derive", "compose", "upsample")


def program_records():
    """``(records, dropped)`` of the program's recorder, or None where the
    program has none."""
    try:
        from opticalflow2d_tpu_torch.utils import profiling
    except ImportError:
        return None
    records, dropped = getattr(profiling, "records", None), getattr(profiling, "dropped", None)
    if records is None or dropped is None:
        return None
    return records(), dropped()


class ProgramSpans:
    """The spans as a tree, cut into disjoint segments each named by the
    innermost span covering it."""

    def __init__(self, records: list):
        self.names = [r[0] for r in records]
        self.parents = [r[3] for r in records]
        ends = [r[1] + r[2] if r[2] is not None else float("inf") for r in records]
        children = [[] for _ in records]
        for i, p in enumerate(self.parents):
            if 0 <= p < len(records):
                children[p].append(i)
        segs = []
        for i, r in enumerate(records):
            t = r[1]
            for c in sorted(children[i], key=lambda c: records[c][1]):
                a, b = max(records[c][1], r[1]), min(ends[c], ends[i])
                if a > t:
                    segs.append((t, a, i))
                t = max(t, b)
            if ends[i] > t:
                segs.append((t, ends[i], i))
        segs.sort()
        # A span that strays out of its parent (a collection started in a
        # sibling's set-up) is cut where the next segment begins.
        self.segs = [(a, min(b, segs[k + 1][0]) if k + 1 < len(segs) else b, i)
                     for k, (a, b, i) in enumerate(segs)]
        self.starts = [a for a, _, _ in self.segs]

    def at(self, t: float) -> int:
        """Index of the innermost span open at ``t``, or -1."""
        k = bisect.bisect_right(self.starts, t) - 1
        if k >= 0 and self.segs[k][0] <= t < self.segs[k][1]:
            return self.segs[k][2]
        return -1

    def lineage(self, i: int) -> list:
        """The names of span ``i`` and of every span above it."""
        out = []
        while i >= 0:
            out.append(self.names[i])
            i = self.parents[i]
        return out

    def split(self, a: float, b: float) -> dict:
        """Seconds of ``[a, b]`` under each innermost span's name;
        ``outside`` for the part no span covers."""
        out, covered = {}, 0.0
        k = max(bisect.bisect_right(self.starts, a) - 1, 0)
        while k < len(self.segs) and self.segs[k][0] < b:
            s0, s1, i = self.segs[k]
            t = min(s1, b) - max(s0, a)
            if t > 0:
                out[self.names[i]] = out.get(self.names[i], 0.0) + t
                covered += t
            k += 1
        if b - a - covered > 1e-12:
            out["outside"] = out.get("outside", 0.0) + (b - a - covered)
        return out

    def self_seconds(self, names, window: tuple) -> float:
        """Seconds of ``window`` whose innermost span is one of ``names``."""
        parts = self.split(*window)
        return sum(parts.get(n, 0.0) for n in names)


def load(p: trace.Profile):
    """The program's spans for the profile ``p``, or None (see above)."""
    got = program_records()
    if got is None:
        return None
    records, dropped = got
    w0, w1 = p.window
    if not any(w0 <= r[1] <= w1 for r in records):
        return None
    # Records are kept in the order spans open, and once the list is full
    # every later one is dropped: the window may have lost some unless the
    # last kept span opened after it.
    if dropped and records[-1][1] <= w1:
        return None
    return ProgramSpans(records)


def idle_under(p: trace.Profile, spans: ProgramSpans) -> dict:
    """Device-idle seconds of the window by innermost program span."""
    out = {}
    for a, b in trace.idle_gaps(p):
        for name, t in spans.split(a, b).items():
            out[name] = out.get(name, 0.0) + t
    return out


def idle_pct(p: trace.Profile, names) -> float | None:
    """100 x the device-idle time of the window whose innermost program
    span is one of ``names``, over the window."""
    spans = load(p)
    window = p.window[1] - p.window[0]
    if spans is None or window <= 0:
        return None
    idle = idle_under(p, spans)
    return 100.0 * sum(idle.get(n, 0.0) for n in names) / window
