"""The port's own spans (``utils.profiling.span``) on the CPU: what a traced
registration records, that the records nest and share their request, that
they sit on the profiler's clock, and that nothing is kept without a
profiler."""

import gc
import glob
import json
import math

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import opticalflow2d_tpu_torch as T
from _torch_helpers import tiled_pair
from opticalflow2d_tpu_torch.engine import registration
from opticalflow2d_tpu_torch.parallel import register_batch
from opticalflow2d_tpu_torch.utils import profiling

SHAPE = (64, 64)
NSCALES, NREFINE = 2, 2


@pytest.fixture(autouse=True)
def _empty_recorder():
    profiling.clear()
    yield
    profiling.clear()


def _traced(fn):
    """``fn()`` under ``torch.profiler``: ``(its result, the records, the
    profiler's raw events)``."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, profiling.records(), prof.profiler.kineto_results.events()


def _session(method=T.Method.DIFFUSION, regparams=(0.1,), niter=(60, 60, 60), **kw):
    return T.OpticalFlow2d(SHAPE, list(niter), NSCALES, method, list(regparams),
                           nrefine=NREFINE, device="cpu", **kw)


def _request(sess, iref, imov):
    result = sess.register(iref, imov)
    return result, sess.get_motion(), sess.warp(imov)


def _named(records, name):
    return [r for r in records if r[0] == name]


def _children(records, i, name=None):
    return [r for r in records if r[3] == i and (name is None or r[0] == name)]


def test_a_diffusion_request_records_its_layers():
    iref, imov = tiled_pair(*SHAPE)
    sess = _session()
    (result, _, _), recs, _ = _traced(lambda: _request(sess, iref, imov))
    assert len(_named(recs, "register")) == 1
    solves = _named(recs, "solve")
    assert len(solves) == (NSCALES + 1) * NREFINE
    assert [(s[5]["scale"], s[5]["refine"]) for s in solves] == [
        (s, r) for s in range(NSCALES, -1, -1) for r in range(NREFINE)]
    assert [(s[5]["nx"], s[5]["ny"]) for s in solves] == [
        (SHAPE[0] >> s, SHAPE[1] >> s) for s in range(NSCALES, -1, -1) for _ in range(NREFINE)]
    k = sess.config.block_k
    assert [t.scale for t in result.traces] == [s[5]["scale"] for s in solves]
    want_reads = [math.ceil(t.iterations / k) for t in result.traces]
    assert [len(_children(recs, recs.index(s), "read")) for s in solves] == want_reads
    assert len(_named(recs, "read")) == sum(want_reads)
    assert all(r[5] == {"site": "block"} for r in _named(recs, "read"))
    # Each solve derives once and composes once; a stop inside a block
    # recomputes.
    for s in solves:
        i = recs.index(s)
        assert len(_children(recs, i, "derive")) == len(_children(recs, i, "compose")) == 1
    stops_inside = sum(1 for t in result.traces if t.iterations % k)
    assert len(_named(recs, "recompute")) == stops_inside > 0
    assert len(_named(recs, "pyramid")) == 1
    assert len(_named(recs, "seed")) == NSCALES - 1   # the coarsest level starts at zero
    assert len(_named(recs, "upsample")) == NSCALES


def test_spans_nest_inside_their_parents_and_share_the_request():
    iref, imov = tiled_pair(*SHAPE)
    sess = _session()
    _, recs, _ = _traced(lambda: (_request(sess, iref, imov), _request(sess, imov, iref)))
    registers = _named(recs, "register")
    assert len(registers) == 2 and registers[0][4] != registers[1][4]
    for name, start, dur, parent, request, _ in recs:
        assert dur is not None and dur >= 0
        if parent < 0:
            assert name in ("register", "get_motion", "warp", "gc")
            continue
        p = recs[parent]
        assert p[1] <= start and start + dur <= p[1] + p[2], (name, p[0])
        assert request == p[4]
    # get_motion and warp carry the id of the register whose motion they use.
    for reg in registers:
        assert {r[0] for r in recs if r[3] < 0 and r[4] == reg[4]} == {
            "register", "get_motion", "warp"}
    entries = [r for r in recs if r[3] < 0 and r[0] != "gc"]
    assert [r[0] for r in entries] == ["register", "get_motion", "warp"] * 2


def test_the_functional_entry_and_the_batch_open_one_register():
    iref, imov = tiled_pair(*SHAPE)
    cfg = T.RegConfig(method=T.Method.DIFFUSION, niter=(30, 30, 30), nscales=NSCALES,
                      nrefine=NREFINE)
    result, recs, _ = _traced(lambda: T.register(iref, imov, cfg, device="cpu"))
    assert [r[0] for r in recs if r[3] < 0 and r[0] != "gc"] == ["register"]
    assert len(_named(recs, "solve")) == len(result.traces)
    profiling.clear()
    pairs = torch.stack([torch.from_numpy(iref)] * 2), torch.stack([torch.from_numpy(imov)] * 2)
    result, recs, _ = _traced(lambda: register_batch(*pairs, cfg, impl="vmap", device="cpu"))
    assert [r[0] for r in recs if r[3] < 0 and r[0] != "gc"] == ["register"]
    assert len(_named(recs, "solve")) == len(result.traces)
    # One read a block for both pairs: the block count of the slower one.
    want = sum(math.ceil(int(t.iterations.max()) / cfg.block_k) for t in result.traces)
    assert len(_named(recs, "read")) == want
    assert all(r[5] == {"site": "batch"} for r in _named(recs, "read"))
    assert len(_named(recs, "pyramid")) == 1 and len(_named(recs, "upsample")) == NSCALES


@pytest.mark.parametrize("method,regparams,site", [
    (T.Method.FLUID, (0.25, 0.0), "fluid"),
    (T.Method.THIRIONS_DEMONS, (1.0, 0.25, 2.0, 2.0, 5, 0), "demons"),
])
def test_fluid_and_demons_read_once_an_iteration(method, regparams, site):
    iref, imov = tiled_pair(*SHAPE)
    extra = {"regrid_threshold": 0.95} if method == T.Method.FLUID else {}
    sess = _session(method, regparams, niter=(12, 8, 6), **extra)
    (result, _, _), recs, _ = _traced(lambda: _request(sess, iref, imov))
    solves = _named(recs, "solve")
    assert len(solves) == len(result.traces) == (NSCALES + 1) * NREFINE
    for s, t in zip(solves, result.traces):
        i = recs.index(s)
        reads = _children(recs, i, "read")
        assert len(reads) == t.iterations and all(r[5] == {"site": site} for r in reads)
        # A regrid composes and derives again, inside a regrid span of the
        # solve; the solve's own derive and compose stay its children.
        assert len(_children(recs, i, "derive")) == 1
        assert len(_children(recs, i, "compose")) == 1
        regrids = _children(recs, i, "regrid")
        assert len(regrids) == t.regrids
        for r in regrids:
            j = recs.index(r)
            assert len(_children(recs, j, "compose")) == len(_children(recs, j, "derive")) == 1
    if method == T.Method.FLUID:
        assert sum(t.regrids for t in result.traces) > 0


def test_a_fluid_regrid_records_one_regrid_span():
    """Each regrid of a fluid solve is one ``regrid`` span holding its
    compose and its derive, with the level's scale and size; without a
    profiler the same run records nothing; a diffusion run has no regrid."""
    iref, imov = tiled_pair(*SHAPE)
    sess = _session(T.Method.FLUID, (0.25, 0.0), niter=(12, 8, 6), regrid_threshold=0.95)
    (result, _, _), recs, _ = _traced(lambda: _request(sess, iref, imov))
    regrids = _named(recs, "regrid")
    assert len(regrids) == sum(t.regrids for t in result.traces) > 0
    for r in regrids:
        j = recs.index(r)
        assert [c[0] for c in _children(recs, j) if c[0] != "gc"] == ["compose", "derive"]
        solve = recs[r[3]]
        assert solve[0] == "solve"
        assert r[5] == {k: solve[5][k] for k in ("scale", "nx", "ny")}
    profiling.clear()
    again = _request(sess, iref, imov)[0]
    assert sum(t.regrids for t in again.traces) == len(regrids)
    assert profiling.records() == []
    _, recs, _ = _traced(lambda: _request(_session(), iref, imov))
    assert not _named(recs, "regrid")


def test_nothing_is_recorded_without_a_profiler():
    iref, imov = tiled_pair(*SHAPE)
    _request(_session(), iref, imov)
    assert profiling.records() == [] and profiling.dropped() == 0
    assert profiling.span("solve", scale=0) is profiling.NULL_SPAN
    assert profiling.entry("register") is profiling.NULL_SPAN


def test_the_bound_drops_and_counts():
    rec = profiling.SpanRecorder(capacity=3)
    with profile(activities=[ProfilerActivity.CPU]):
        with rec.span("a"):
            with rec.span("b", site="x"):
                pass
            for _ in range(4):
                with rec.span("c"):
                    pass
    kept = rec.records()
    assert [r[0] for r in kept] == ["a", "b", "c"] and rec.dropped() == 3
    assert [r[3] for r in kept] == [-1, 0, 0] and kept[1][5] == {"site": "x"}
    rec.clear()
    assert rec.records() == [] and rec.dropped() == 0


def test_register_encloses_its_aten_events_on_the_profilers_clock():
    iref, imov = tiled_pair(*SHAPE)
    sess = _session(niter=(20, 20, 20))
    _, recs, events = _traced(lambda: _request(sess, iref, imov))
    reg = _named(recs, "register")[0]
    first = _named(recs, "derive")[0]
    aten = [(e.start_ns() * 1e-9, (e.start_ns() + e.duration_ns()) * 1e-9) for e in events
            if e.name().startswith("aten::")]
    inside = [a for a in aten if reg[1] <= a[0] and a[1] <= reg[1] + reg[2]]
    assert len(inside) > 100
    # The first derive's operations start inside it, none before the
    # register span opened.
    assert any(first[1] <= a[0] <= first[1] + first[2] for a in aten)
    assert not any(reg[1] - 1e-3 < a[0] < reg[1] for a in aten)


def test_a_collection_in_a_traced_run_is_a_gc_span():
    def run():
        with profiling.span("solve", scale=0):
            gc.collect()

    _, recs, _ = _traced(run)
    gcs = _named(recs, "gc")
    assert gcs and all(r[3] == 0 and r[4] == recs[0][4] for r in gcs)
    assert any(r[5]["generation"] == 2 for r in gcs)


def test_the_chrome_trace_holds_the_spans_over_their_operations(tmp_path):
    iref, imov = tiled_pair(*SHAPE)
    cfg = T.RegConfig(method=T.Method.DIFFUSION, niter=(20, 20, 20), nscales=NSCALES,
                      nrefine=NREFINE)
    with profiling.trace(str(tmp_path)):
        T.register(iref, imov, cfg, device="cpu")
    (path,) = glob.glob(str(tmp_path / "trace_*.json"))
    events = json.load(open(path))["traceEvents"]
    ours = [e for e in events if e.get("cat") == "program"]
    solves = [e for e in ours if e["name"] == "solve"]
    assert len(solves) == (NSCALES + 1) * NREFINE
    assert [e["name"] for e in ours if e["args"]["parent"] < 0] == ["register"]
    assert {e["tid"] for e in ours} == {profiling._SPAN_TID}
    ops = [e for e in events if e.get("cat") == "cpu_op" and e.get("ph") == "X"]
    for s in solves:
        covered = [o for o in ops
                   if s["ts"] <= o["ts"] and o["ts"] + o["dur"] <= s["ts"] + s["dur"]]
        assert covered, s["args"]
    # The spans were cleared when the trace started: one run's worth.
    assert len(profiling.records()) == len(ours)


def test_each_discarded_block_is_one_discard_span_inside_its_solve():
    """The blocked loop's lookahead drops the block it launched ahead when
    the stop lands in the block before: one ``discard`` span, with no
    attributes, inside that solve, and nowhere else. Without a profiler
    the same run records nothing; the fluid loop has no lookahead."""
    iref, imov = tiled_pair(*SHAPE)
    sess = _session()
    k = sess.config.block_k
    before = dict(registration.LOOKAHEAD)
    (result, _, _), recs, _ = _traced(lambda: _request(sess, iref, imov))
    discarded = registration.LOOKAHEAD["discarded"] - before["discarded"]
    solves = _named(recs, "solve")
    want = [int(math.ceil(t.iterations / k) * k < sess.config.niter[t.scale])
            for t in result.traces]
    assert [len(_children(recs, recs.index(s), "discard")) for s in solves] == want
    assert len(_named(recs, "discard")) == sum(want) == discarded > 0
    assert all(r[5] is None and recs[r[3]][0] == "solve" for r in _named(recs, "discard"))
    profiling.clear()
    _request(sess, iref, imov)
    assert registration.LOOKAHEAD["discarded"] - before["discarded"] == 2 * discarded
    assert profiling.records() == []
    fluid = _session(T.Method.FLUID, (0.25, 0.0), niter=(12, 8, 6))
    before = dict(registration.LOOKAHEAD)
    _, recs, _ = _traced(lambda: _request(fluid, iref, imov))
    assert _named(recs, "solve") and not _named(recs, "discard")
    assert registration.LOOKAHEAD == before
