"""The traced part of a run: ``torch.profiler`` over whole requests, its
events reduced to plain records that the per-layer readers take.

A record is ``[name, start_s, dur_s]`` on the profiler's clock. ``device``
holds the device operations (kernels, copies and sets), ``runtime`` the
CUDA runtime calls, ``spans`` the benchmark's own host spans
(``bench.request``, ``bench.register``, ``bench.get_motion``,
``bench.warp``). ``Profile`` adds what the readers need besides: the
traced requests' solves, the window, the names of the kernels built from
the program's own CUDA sources, and the configuration.
"""

from __future__ import annotations

import bisect
import dataclasses
import re
import shutil
import subprocess
from pathlib import Path

SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
              "cudaMemcpy")


@dataclasses.dataclass
class Profile:
    device: list            # [name, start_s, dur_s, kind]
    runtime: list           # [name, start_s, dur_s]
    spans: list             # [name, start_s, dur_s]
    window: tuple           # (start_s, end_s) of the traced requests
    solves: list            # per traced request: [[scale, iterations, regrids], ...]
    dims: list              # the configuration's image size
    nscales: int
    block_k: int
    library_kernels: list   # base names of the kernels of the program's own library
    peaks: dict


def kernel_base(name: str) -> str:
    """The bare function name of a kernel as the profiler or ``nm -C``
    prints it: ``void ns::f<8, true>(float const*, ...)`` -> ``f``."""
    head = re.split(r"[<(]", name.replace("(anonymous namespace)::", ""), maxsplit=1)[0]
    base = head.split()[-1].split("::")[-1] if head.strip() else ""
    return base or name


def checkout_libraries(root: Path) -> list:
    """The shared libraries this process loaded from inside the checkout
    ``root``: the program's own, built there."""
    libs = set()
    with open("/proc/self/maps") as maps:
        for line in maps:
            path = line.split()[-1]
            if path.endswith(".so") and path.startswith(str(root) + "/"):
                libs.add(path)
    return sorted(libs)


def library_kernels(root: Path) -> list:
    """Base names of the functions in the shared libraries this process
    loaded from inside the checkout ``root`` (the program's own CUDA
    kernels), read with ``nm``; empty where ``nm`` is missing."""
    nm = shutil.which("nm")
    if nm is None:
        return []
    names = set()
    for lib in checkout_libraries(root):
        out = subprocess.run([nm, "-C", "--defined-only", lib], capture_output=True,
                             text=True, check=False).stdout
        for line in out.splitlines():
            parts = line.split(maxsplit=2)
            if len(parts) == 3 and parts[1] in "Tt":
                names.add(kernel_base(parts[2]))
    return sorted(names)


def _seconds(e, what: str) -> float:
    """An event's ``start`` or ``duration`` in seconds (ns where the
    event offers it, else us)."""
    ns = getattr(e, f"{what}_ns", None)
    return ns() * 1e-9 if ns is not None else getattr(e, f"{what}_us")() * 1e-6


def reduce_events(events) -> tuple:
    """``(device, runtime, spans)`` records of the profiler's raw events,
    in seconds on the profiler's clock. An event on the CUDA device is a
    copy (``Memcpy ...``), a set (``Memset ...``) or a kernel, unless it
    is a benchmark span mirrored there; on the host, a ``cuda*`` call is
    a runtime call and a ``bench.*`` range a span."""
    from torch.autograd import DeviceType

    device, runtime, spans = [], [], []
    for e in events:
        name = e.name()
        rec = [name, _seconds(e, "start"), _seconds(e, "duration")]
        if e.device_type() == DeviceType.CUDA:
            if name.startswith("bench."):
                continue
            kind = ("gpu_memcpy" if name.startswith("Memcpy")
                    else "gpu_memset" if name.startswith("Memset") else "kernel")
            device.append(rec + [kind])
        elif name.startswith("bench."):
            spans.append(rec)
        elif name.startswith("cuda"):
            runtime.append(rec)
    device.sort(key=lambda r: r[1])
    return device, runtime, spans


def busy_intervals(device: list, window: tuple) -> list:
    """The union of the device operations' intervals, clipped to
    ``window``, as sorted disjoint ``[start, end]``."""
    lo, hi = window
    merged = []
    for _, s, d, *_ in sorted(device, key=lambda r: r[1]):
        a, b = max(s, lo), min(s + d, hi)
        if b <= a:
            continue
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def busy_seconds(p: Profile) -> float:
    return sum(b - a for a, b in busy_intervals(p.device, p.window))


def iterations(p: Profile) -> int:
    return sum(it for solves in p.solves for _, it, _ in solves)


class SpanIndex:
    """Which benchmark spans cover a stretch of time: the request spans
    and the spans inside them (``register``, ``get_motion``, ``warp``),
    each list sorted and disjoint."""

    def __init__(self, spans: list):
        self.inner = sorted((s, s + d, n.removeprefix("bench."))
                            for n, s, d in spans if n != "bench.request")
        self.outer = sorted((s, s + d) for n, s, d in spans if n == "bench.request")
        self.inner_starts = [s for s, _, _ in self.inner]
        self.outer_starts = [s for s, _ in self.outer]

    def at(self, t: float) -> str:
        """The innermost span open at ``t``: a span's name, ``request``
        or ``outside``."""
        i = bisect.bisect_right(self.inner_starts, t) - 1
        if i >= 0 and self.inner[i][0] <= t <= self.inner[i][1]:
            return self.inner[i][2]
        i = bisect.bisect_right(self.outer_starts, t) - 1
        if i >= 0 and self.outer[i][0] <= t <= self.outer[i][1]:
            return "request"
        return "outside"

    @staticmethod
    def _overlaps(spans, starts, a: float, b: float):
        i = max(bisect.bisect_right(starts, a) - 1, 0)
        while i < len(spans) and spans[i][0] < b:
            lo, hi = max(spans[i][0], a), min(spans[i][1], b)
            if hi > lo:
                yield spans[i], hi - lo
            i += 1

    def split(self, a: float, b: float) -> dict:
        """Seconds of ``[a, b]`` under each innermost span."""
        out = {}
        inner = 0.0
        for span, t in self._overlaps(self.inner, self.inner_starts, a, b):
            out[span[2]] = out.get(span[2], 0.0) + t
            inner += t
        outer = sum(t for _, t in self._overlaps(self.outer, self.outer_starts, a, b))
        for key, t in (("request", outer - inner), ("outside", (b - a) - outer)):
            if t > 1e-12:
                out[key] = out.get(key, 0.0) + t
        return out


def idle_gaps(p: Profile) -> list:
    """``(start, end)`` of every idle stretch of the window."""
    busy = busy_intervals(p.device, p.window)
    edges = [p.window[0]] + [x for iv in busy for x in iv] + [p.window[1]]
    return [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]


def idle_by_span(p: Profile) -> dict:
    """Idle seconds of the window summed by the host span they fell in."""
    index = SpanIndex(p.spans)
    out = {}
    for a, b in idle_gaps(p):
        for key, t in index.split(a, b).items():
            out[key] = out.get(key, 0.0) + t
    return out


def breakdown(p: Profile, top: int = 10) -> dict:
    """The device operations that took most time (summed by name) and the
    longest idle gaps inside the window, each named by the host span that
    covers most of it."""
    by_name = {}
    for name, _, d, _ in p.device:
        key = name if len(name) <= 120 else name[:117] + "..."
        by_name[key] = by_name.get(key, 0.0) + d
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(idle_gaps(p), key=lambda g: -(g[1] - g[0]))[:top]
    index = SpanIndex(p.spans)
    idle = []
    for a, b in gaps:
        parts = index.split(a, b)
        idle.append([max(parts, key=parts.get), b - a])
    return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": idle}
