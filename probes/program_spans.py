"""Lay the program's own spans over one traced window of a benchmark cell,
on one card, and print what they say about the idle device.

    python3 probes/program_spans.py --workload slide_hs_4096.pair --seed N \
        --seconds 51 --out results.jsonl

Runs the cell as ``torch_bench/run.py --trace 1`` does (the profiler over
its first ``trace_seconds``) and keeps the traced profile. Prints one JSON
line: the result's per-layer metrics; the device-idle seconds by innermost
program span, over the window and inside the benchmark's ``register``
spans, with the share of the latter that a span below the entry covers;
the ten longest idle gaps, each named by the program span that covers most
of it; the clock checks (each B1 launch starts after its ``solve`` opened,
each ``read`` ends no earlier than the B1 launch it waited on; a block
launched ahead and dropped is skipped); the spans a request; the level
loop's idle and reads a request by scale; the 20 costliest runtime calls a
request (count and host ms); the device seconds by operation (the 25 largest, by the first
100 characters of the name); the traced requests' solves; and the
recorder's cost a span, off and on, timed on this host. Needs one CUDA
card.
"""
import argparse
import bisect
import json
import sys
import timeit
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def recorder_cost() -> dict:
    """Seconds a span costs with no profiler and under one, the best of 5
    loops of 200,000 (40,000 under the profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from opticalflow2d_tpu_torch.utils.profiling import SpanRecorder

    rec = SpanRecorder()

    def one():
        with rec.span("read", site="block"):
            pass

    off = min(timeit.repeat(one, number=200_000, repeat=5)) / 200_000
    check = min(timeit.repeat(torch.autograd._profiler_enabled, number=200_000,
                              repeat=5)) / 200_000
    with profile(activities=[ProfilerActivity.CPU]):
        on = []
        for _ in range(5):
            rec.clear()
            on.append(timeit.timeit(one, number=40_000) / 40_000)
    return {"off_s": off, "check_s": check, "on_s": min(on)}


def quantiles(xs) -> dict:
    """The least, the 1st, 50th and 99th percentiles and the most of ``xs``."""
    if not xs:
        return {}
    xs = sorted(xs)
    at = {q: xs[min(len(xs) - 1, int(q * len(xs)))] for q in (0.01, 0.5, 0.99)}
    return {"min": xs[0], "p01": at[0.01], "p50": at[0.5], "p99": at[0.99], "max": xs[-1],
            "n": len(xs)}


def thirds(times, values) -> list:
    """The median of ``values`` in each third of the window, by ``times``."""
    if not times:
        return []
    span = max(times) or 1.0
    out = []
    for k in range(3):
        part = sorted(v for t, v in zip(times, values) if k / 3 <= t / span <= (k + 1) / 3)
        out.append(part[len(part) // 2] if part else None)
    return out


def clipped(intervals, window):
    lo, hi = window
    return [(max(a, lo), min(b, hi)) for a, b in intervals if min(b, hi) > max(a, lo)]


def analyse(p, result: dict) -> dict:
    from torch_bench import program_spans, trace
    from torch_bench.rooflines import diffusion_block as b1

    spans = program_spans.load(p)
    recs = program_spans.program_records()[0]
    window = p.window[1] - p.window[0]
    gaps = trace.idle_gaps(p)
    idle = program_spans.idle_under(p, spans)
    below = program_spans.LOOP + program_spans.OPS + ("gc",)
    # Idle inside the benchmark's register spans, by innermost program span.
    bench_register = [(s, s + d) for n, s, d in p.spans if n == "bench.register"]
    in_register = {}
    for a, b in gaps:
        for lo, hi in clipped(bench_register, (a, b)):
            for name, t in spans.split(lo, hi).items():
                in_register[name] = in_register.get(name, 0.0) + t
    total_in_register = sum(in_register.values())
    covered = sum(in_register.get(n, 0.0) for n in below)
    longest = []
    for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:10]:
        parts = spans.split(a, b)
        bench = trace.SpanIndex(p.spans).split(a, b)
        longest.append({"ms": 1e3 * (b - a), "program": max(parts, key=parts.get),
                        "parts_ms": {n: 1e3 * t for n, t in parts.items()},
                        "bench": max(bench, key=bench.get)})
    # The clock checks: the solves' B1 launches in order, one a read.
    inside = [(i, r) for i, r in enumerate(recs) if p.window[0] <= r[1] <= p.window[1]]
    solves = [(i, r) for i, r in inside if r[0] == "solve"]
    reads = {}
    for i, r in inside:
        if r[0] == "read":
            reads.setdefault(r[3], []).append(r)
    kernels = sorted((s, s + d) for n, s, d, k in p.device
                     if k == "kernel" and trace.kernel_base(n) in b1.KERNELS)
    # A block the loop launched ahead and dropped (a ``discard`` span in
    # its solve) follows the solve's last read.
    discards = {}
    for i, r in inside:
        if r[0] == "discard":
            discards[r[3]] = discards.get(r[3], 0) + 1
    pairs, k = [], 0
    for i, s in solves:
        for r in reads.get(i, []):
            if k < len(kernels):
                pairs.append((s, r, kernels[k]))
            k += 1
        k += discards.get(i, 0)
    start_margin = [kern[0] - s[1] for s, _, kern in pairs]
    end_margin = [r[1] + r[2] - kern[1] for _, r, kern in pairs]
    # Each read's margin split at the stream sync inside it: read end less
    # sync end (host clock against host clock) and sync end less B1's end
    # (the profiler's host clock against its device clock).
    syncs = sorted((s, s + d) for n, s, d in p.runtime
                   if n in ("cudaStreamSynchronize", "cudaEventSynchronize"))
    sync_starts = [a for a, _ in syncs]
    host_margin, device_margin, when = [], [], []
    for _, r, kern in pairs:
        j = bisect.bisect_right(sync_starts, r[1] + r[2]) - 1
        if j >= 0 and syncs[j][0] >= r[1]:
            host_margin.append(r[1] + r[2] - syncs[j][1])
            device_margin.append(syncs[j][1] - kern[1])
            when.append(kern[1] - p.window[0])
    n_requests = len(p.solves)
    # The level loop's idle (innermost span in LOOP) by the scale of its
    # solve, and the reads a request at each scale.
    loop_by_scale, reads_by_scale = {}, {}
    scale_of = {i: r[5]["scale"] for i, r in solves}
    for a, b in gaps:
        j = max(bisect.bisect_right(spans.starts, a) - 1, 0)
        while j < len(spans.segs) and spans.segs[j][0] < b:
            s0, s1, i = spans.segs[j]
            t = min(s1, b) - max(s0, a)
            if t > 0 and spans.names[i] in program_spans.LOOP:
                while i >= 0 and spans.names[i] != "solve":
                    i = spans.parents[i]
                if i in scale_of:
                    loop_by_scale[scale_of[i]] = loop_by_scale.get(scale_of[i], 0.0) + t
            j += 1
    for i, rs in reads.items():
        if i in scale_of:
            reads_by_scale[scale_of[i]] = reads_by_scale.get(scale_of[i], 0) + len(rs)
    calls = {}
    for n, _, d in p.runtime:
        c = calls.setdefault(n, [0, 0.0])
        c[0] += 1
        c[1] += d
    by_kernel = {}
    for n, _, d, _ in p.device:
        by_kernel[n[:100]] = by_kernel.get(n[:100], 0.0) + d
    names = {}
    for _, r in inside:
        names[r[0]] = names.get(r[0], 0) + 1
    return {
        "metrics": {n: m["value"] for n, m in result["metrics"].items()},
        "device": result["device"],
        "traced_requests": n_requests,
        "window_s": window,
        "idle_s": sum(b - a for a, b in gaps),
        "idle_by_program_span_s": idle,
        "idle_in_bench_register_s": total_in_register,
        "idle_in_bench_register_by_span_s": in_register,
        "covered_below_entry": covered / total_in_register if total_in_register else None,
        "longest_gaps": longest,
        "b1_kernels": len(kernels), "b1_reads": k,
        "b1_start_after_solve": all(m >= 0 for m in start_margin),
        "b1_start_margin_min_s": min(start_margin) if start_margin else None,
        "read_end_minus_b1_end_min_s": min(end_margin) if end_margin else None,
        "reads_ending_50us_before_b1": sum(1 for m in end_margin if m < -50e-6),
        "read_end_minus_b1_end_q": quantiles(end_margin),
        "read_end_minus_sync_end_q": quantiles(host_margin),
        "sync_end_minus_b1_end_q": quantiles(device_margin),
        "sync_end_minus_b1_end_by_third_median_s": thirds(when, device_margin),
        "spans_per_request": {n: c / n_requests for n, c in sorted(names.items())},
        "loop_idle_ms_per_request_by_scale": {
            sc: 1e3 * t / n_requests for sc, t in sorted(loop_by_scale.items())},
        "reads_per_request_by_scale": {
            sc: c / n_requests for sc, c in sorted(reads_by_scale.items())},
        "runtime_calls_per_request": {
            n: [c / n_requests, 1e3 * d / n_requests]
            for n, (c, d) in sorted(calls.items(), key=lambda kv: -kv[1][1])[:20]},
        "device_s_by_op": dict(sorted(by_kernel.items(), key=lambda kv: -kv[1])[:25]),
        "solves": p.solves,
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", default="slide_hs_4096.pair")
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, default=51.0)
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)

    import torch

    from torch_bench import cells, run

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    torch.set_num_threads(1)
    captured = []
    original = run.profile_of

    def profile_of(*a, **kw):
        captured.append(original(*a, **kw))
        return captured[-1]

    run.profile_of = profile_of
    spec = cells.load_spec()
    _, config, traffic = cells.find(spec, args.workload)
    result = run.run_cell(spec, args.workload, config, traffic, args.seed, args.seconds, True,
                          torch.device("cuda", 0))
    line = {"workload": args.workload, "seed": args.seed, "correct": result["correct"],
            **analyse(captured[0], result), "recorder": recorder_cost()}
    text = json.dumps(line)
    print(text, flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.path[0] = str(ROOT)
    sys.exit(main())
