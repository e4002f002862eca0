"""Profiling helpers (PyTorch port of ``opticalflow2d_tpu.utils.profiling``):
a ``torch.profiler`` trace written as a Chrome trace, the program's own
spans, and a kernel timer that takes the slope between two loop lengths, so
that the fixed cost of a call (launch, synchronisation) cancels.

Spans. ``span(name, ...)`` marks a stretch of the program's host time: an
entry call (``register``, ``get_motion``, ``warp``), a level solve, the
host read of a block, a pyramid build. A span is recorded only while a
``torch.profiler`` runs (``torch.autograd._profiler_enabled()``); otherwise
``span`` returns one shared object that does nothing, and reads no clock.
A record holds the span's name, its start and end on ``time.time_ns()``
(the clock of the profiler's own events), the index of the span it opened
inside, the request it belongs to, and a few attributes (``scale``,
``refine``, ``nx``, ``ny``, ``site``, ``pairs``). Records stay in memory,
at most ``MAX_RECORDS``; ``records()`` returns them in seconds,
``clear()`` drops them, ``trace()`` clears them when it starts and writes
them beside the profiler's events. A Python garbage collection that runs
while the recorder is on is recorded as a ``gc`` span.
"""

from __future__ import annotations

import contextlib
import gc
import itertools
import json
import os
import tempfile
import threading
import time
from typing import Callable

import torch

MAX_RECORDS = 1 << 20
_profiler_enabled = torch.autograd._profiler_enabled


class _NullSpan:
    """The span of a recorder that is off, or full: it does nothing."""

    __slots__ = ()
    request = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NULL_SPAN = _NullSpan()


class _Span:
    """An open recorded span; closing it stamps its end."""

    __slots__ = ("name", "index", "request", "epoch", "_recorder")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        t = time.time_ns()
        self._recorder._close(self, t)
        return False


_ATTRS = ("scale", "refine", "nx", "ny", "site", "pairs")


class SpanRecorder:
    """The program's spans while a profiler runs, at most ``capacity``.

    A record is ``name, start_ns, end_ns, parent, request, attrs``:
    ``parent`` the index of the innermost span open in the same thread when
    it opened (-1 for none), ``request`` the id it shares with its parent,
    ``end_ns`` 0 while it is open. Past ``capacity`` records a span is not
    kept and ``dropped()`` counts it. The records are kept as columns of
    numbers and shared strings and attribute dicts, so that a long trace
    adds next to nothing for the garbage collector to walk."""

    def __init__(self, capacity: int = MAX_RECORDS):
        self.capacity = capacity
        self._local = threading.local()
        self._requests = itertools.count(1)
        self._attr_cache = {}
        self._gc_start = None
        self._epoch = 0
        self.clear()

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _parent(self, stack: list):
        return stack[-1] if stack and stack[-1].epoch == self._epoch else None

    def _attrs(self, key: tuple, names: tuple):
        attrs = self._attr_cache.get(key)
        if attrs is None:
            attrs = self._attr_cache[key] = {n: v for n, v in zip(names, key)
                                             if v is not None}
        return attrs

    def span(self, name: str, *, request=None, scale=None, refine=None, nx=None, ny=None,
             site=None, pairs=None):
        """A context manager that records ``name`` while a profiler runs.
        ``request`` defaults to the parent span's (a new one at top level);
        the other keywords are kept as attributes when given."""
        if not _profiler_enabled():
            return NULL_SPAN
        key = (scale, refine, nx, ny, site, pairs)
        return self._open(name, request, None if key == (None,) * 6 else
                          self._attrs(key, _ATTRS))

    def entry(self, name: str, request=None):
        """The span of a public entry call: a new request unless
        ``request`` (an earlier span's ``.request``) is given, and nothing
        inside an open span of the same name, so that an entry calling
        another records one span."""
        if not _profiler_enabled():
            return NULL_SPAN
        if any(s.name == name and s.epoch == self._epoch for s in self._stack()):
            return NULL_SPAN
        return self._open(name, next(self._requests) if request is None else request, None)

    def _append(self, name, start, end, parent, request, attrs) -> int:
        i = len(self._names)
        self._names.append(name)
        self._starts.append(start)
        self._ends.append(end)
        self._parents.append(parent)
        self._reqs.append(request)
        self._attr_col.append(attrs)
        return i

    def _open(self, name, request, attrs):
        stack = self._stack()
        parent = self._parent(stack)
        if request is None:
            request = parent.request if parent is not None else next(self._requests)
        if len(self._names) >= self.capacity:
            self._dropped += 1
            return NULL_SPAN
        s = _Span()
        s.name, s.request, s.epoch, s._recorder = name, request, self._epoch, self
        s.index = self._append(name, 0, 0, -1 if parent is None else parent.index, request,
                               attrs)
        stack.append(s)
        # The clock is read last: a collection that the allocations above
        # start ends before the span begins.
        self._starts[s.index] = time.time_ns()
        return s

    def _close(self, s: _Span, t: int) -> None:
        if s.epoch == self._epoch:
            self._ends[s.index] = t
        stack = self._stack()
        if stack and stack[-1] is s:
            stack.pop()
        elif s in stack:
            stack.remove(s)

    def on_gc(self, phase: str, info: dict) -> None:
        """A ``gc.callbacks`` hook: a collection while the recorder is on
        becomes a ``gc`` span inside the innermost open one."""
        if not _profiler_enabled():
            return
        if phase == "start":
            self._gc_start = time.time_ns()
            return
        start, self._gc_start = self._gc_start, None
        if start is None:
            return
        end = time.time_ns()
        if len(self._names) >= self.capacity:
            self._dropped += 1
            return
        parent = self._parent(self._stack())
        self._append("gc", start, end, -1 if parent is None else parent.index,
                     None if parent is None else parent.request,
                     self._attrs((info.get("generation"),), ("generation",)))

    def raw(self) -> list:
        """``[name, start_ns, end_ns, parent, request, attrs]`` of every
        kept span, in the order they opened; ``end_ns`` 0 for a span still
        open."""
        return [[n, s, e, p, r, None if a is None else dict(a)]
                for n, s, e, p, r, a in zip(self._names, self._starts, self._ends,
                                            self._parents, self._reqs, self._attr_col)]

    def records(self) -> list:
        """``[name, start_s, dur_s, parent, request, attrs]`` of every kept
        span, in the order they opened; ``dur_s`` is None for a span still
        open."""
        return [[n, s * 1e-9, (e - s) * 1e-9 if e else None, p, r, a]
                for n, s, e, p, r, a in self.raw()]

    def dropped(self) -> int:
        """Spans not kept since the last ``clear()``, for want of room."""
        return self._dropped

    def clear(self) -> None:
        """Drop every record; spans open now are no one's parent."""
        self._names, self._starts, self._ends = [], [], []
        self._parents, self._reqs, self._attr_col = [], [], []
        self._dropped = 0
        self._epoch += 1


RECORDER = SpanRecorder()
span = RECORDER.span
entry = RECORDER.entry
records = RECORDER.records
dropped = RECORDER.dropped
clear = RECORDER.clear
gc.callbacks.append(RECORDER.on_gc)

# The Chrome trace's track of the program's spans: a thread id no host
# thread has, named and sorted first in the process.
_SPAN_TID = 1 << 30


def _add_spans(path: str, raw: list) -> None:
    """Write the closed spans of ``raw`` into the Chrome trace at ``path``
    as their own host track, on the trace's time base."""
    with open(path) as f:
        data = json.load(f)
    base = int(data.get("baseTimeNanoseconds", 0))
    pid = os.getpid()
    events = [
        {"ph": "M", "name": "thread_name", "pid": pid, "tid": _SPAN_TID,
         "args": {"name": "tpuflow2d spans"}},
        {"ph": "M", "name": "thread_sort_index", "pid": pid, "tid": _SPAN_TID,
         "args": {"sort_index": -1}},
    ]
    for i, (name, s, e, parent, request, attrs) in enumerate(raw):
        if e:
            events.append({"ph": "X", "cat": "program", "name": name, "pid": pid,
                           "tid": _SPAN_TID, "ts": (s - base) / 1e3, "dur": (e - s) / 1e3,
                           "args": {"index": i, "parent": parent, "request": request,
                                    **(attrs or {})}})
    data.setdefault("traceEvents", []).extend(events)
    with open(path, "w") as f:
        json.dump(data, f)


@contextlib.contextmanager
def trace(logdir: str | None = None):
    """Profile the block with ``torch.profiler`` (CPU activity, and CUDA
    activity where a CUDA device is present) and write its Chrome trace
    (``chrome://tracing``, Perfetto) into ``logdir`` when the block ends,
    also when it raises; yields ``logdir``. The default directory is
    ``tpuflow2d-trace`` under the temporary directory. The program's spans
    (``span``) are cleared when the block starts and written into the same
    file, as a host track of their own above the profiler's."""
    if logdir is None:
        logdir = os.path.join(tempfile.gettempdir(), "tpuflow2d-trace")
    os.makedirs(logdir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    clear()
    prof.start()
    try:
        yield logdir
    finally:
        prof.stop()
        path = os.path.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}.json")
        prof.export_chrome_trace(path)
        _add_spans(path, RECORDER.raw())


def _device_of(state) -> torch.device:
    if isinstance(state, torch.Tensor):
        return state.device
    if isinstance(state, dict):
        state = list(state.values())
    if isinstance(state, (tuple, list)):
        for item in state:
            if isinstance(item, (torch.Tensor, tuple, list, dict)):
                return _device_of(item)
    raise TypeError("kernel_timer's state holds no tensor")


def kernel_timer(fn: Callable, state, iters_lo: int = 200, iters_hi: int = 1000,
                 reps: int = 3) -> float:
    """Seconds per iteration of the ``state -> state`` step ``fn``: the
    slope between loops of ``iters_lo`` and ``iters_hi`` steps, each the
    best of ``reps`` runs after one warm-up. On CUDA (the device of the
    first tensor in ``state``) a loop is timed by CUDA events, after a
    synchronisation of the device and up to the end event's completion; on
    the CPU, where every operation returns when done, by ``perf_counter``."""
    if not 0 < iters_lo < iters_hi:
        raise ValueError(f"need 0 < iters_lo < iters_hi, got {iters_lo}, {iters_hi}")
    device = _device_of(state)

    def run(n: int) -> None:
        s = state
        for _ in range(n):
            s = fn(s)

    def timed(n: int) -> float:
        if device.type != "cuda":
            t0 = time.perf_counter()
            run(n)
            return time.perf_counter() - t0
        with torch.cuda.device(device):
            torch.cuda.synchronize(device)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            run(n)
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / 1e3

    def best(n: int) -> float:
        timed(n)  # warm-up
        return min(timed(n) for _ in range(reps))

    t_lo, t_hi = best(iters_lo), best(iters_hi)
    return max(t_hi - t_lo, 1e-12) / (iters_hi - iters_lo)
