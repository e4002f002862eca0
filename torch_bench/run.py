#!/usr/bin/env python3
"""The benchmark of the PyTorch and CUDA port (``opticalflow2d_tpu_torch``).

    python3 torch_bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

One run serves one cell of ``BENCHMARK.json`` on one CUDA device: it makes
the cell's pool of image pairs on the device from the seed, opens the
cell's entry, warms it up on the pool, then runs a closed loop of one
client for ``--seconds``: a request is one pair, or a stack of the
traffic's ``pairs_per_request`` pairs, and the request in flight when the
time is up is finished and counted. It prints,
as the last line of its standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the end-to-end metrics, or with
``--trace 1`` the per-layer ones, read under ``torch.profiler``),
``device``, ``setup`` (the marks of set-up's parts and the seconds the
program's kernel library took to build in this run), with ``--trace 1``
``breakdown``, and last ``check``: each number the correctness comparison
took, beside its limit. Without a CUDA device, or where the process has
loaded JAX or the JAX package by the window's end, it prints no result and
exits with 1.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
# Top-level modules the run may not hold: the port runs without JAX.
NOT_LOADED = ("jax", "jaxlib", "flax", "opticalflow2d_tpu")


def process_age() -> float:
    """Seconds since this process started (``/proc``, 10 ms steps)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def log(*args) -> None:
    print(*args, file=sys.stderr, flush=True)


def power_limit(index: int) -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30, check=False).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"not read ({exc})"
    return out or "not read"


def finite(x: float):
    return x if math.isfinite(x) else None


class Window:
    """What the closed loop saw: each request's latency, the answers kept
    for the check, the traced requests' solves and the profiler's events."""

    def __init__(self):
        self.latencies, self.traced_solves, self.kept = [], [], {}
        self.attempted = self.failed = 0
        self.seconds = 0.0
        self.events = None


def serve(client, pool, seconds: float, checked: set, sync, prof, trace_seconds: float,
          pairs: int, dims) -> Window:
    """The closed loop: one client, one pool entry a request (``pairs``
    pairs of ``dims``), the pool in turn, until ``seconds`` have passed at
    the end of a request; an answer of another shape counts as failed.
    ``prof``, when given and started, is stopped at the end of the first
    request that ends ``trace_seconds`` into the window."""
    from torch.profiler import record_function

    from torch_bench import correct

    w = Window()
    t0 = time.perf_counter()
    while True:
        p = w.attempted % len(pool)
        a = time.perf_counter()
        try:
            with record_function("bench.request"):
                answer = client.request(*pool[p])
            sync()
            correct.check_answer(answer, pairs, dims)
        except Exception:  # a failed request counts against those attempted
            log(traceback.format_exc())
            answer = None
            w.failed += 1
        b = time.perf_counter()
        w.attempted += 1
        w.latencies.append(b - a if answer is not None else float("inf"))
        if answer is not None and p in checked:
            w.kept[p] = answer
        if prof is not None:
            w.traced_solves.append(answer[2] if answer is not None else [])
            if b - t0 >= min(trace_seconds, seconds):
                prof.stop()
                w.events = prof.profiler.kineto_results.events()
                prof = None
        if b - t0 >= seconds:
            w.seconds = b - t0
            return w


def profile_of(w: Window, config: dict, block_k: int, kind: str):
    """The traced requests as a ``trace.Profile``: the events between the
    first traced request's start and the last one's end."""
    from torch_bench import cells, trace

    device, runtime, spans = trace.reduce_events(w.events)
    w.events = None
    req = [(s, s + d) for n, s, d in spans if n == "bench.request"]
    w0, w1 = min(r[0] for r in req), max(r[1] for r in req)

    def inside(recs):
        return [r for r in recs if w0 <= r[1] <= w1]

    peaks = json.loads((cells.BENCH / "peaks.json").read_text()).get(kind, {})
    return trace.Profile(device=inside(device), runtime=inside(runtime), spans=inside(spans),
                         window=(w0, w1), solves=w.traced_solves, dims=list(config["dims"]),
                         nscales=config["settings"]["nscales"], block_k=block_k,
                         library_kernels=trace.library_kernels(ROOT), peaks=peaks)


def check(config: dict, pairs: int, pool, w: Window) -> tuple:
    """``(correct, check)``: every pair of the kept answers against the
    plain reference, run pair by pair once the window has closed and the
    program's state is freed; each number the largest over the pairs."""
    from torch_bench import correct, stats

    readings = []
    for p in sorted(w.kept):
        for i, (answer, (iref, imov)) in enumerate(zip(correct.split(w.kept[p], pairs),
                                                        correct.split(pool[p], pairs))):
            readings.append(correct.gaps(answer, correct.reference_answer(config, iref, imov)))
            log(f"pair {p if pairs == 1 else f'{p}.{i}'}: {readings[-1]}, SSD reduction "
                f"{stats.ssd_reduction(iref, imov, answer[1]):.6f}")
    log(f"pairs checked: {len(readings)}, in {len(w.kept)} request(s) of {pairs} (at least 1)")
    numbers = {n: finite(v) for n, v in correct.worst(readings).items()}
    limits = config["limits"]
    ok = bool(readings) and w.failed == 0 and correct.judge(numbers, limits)
    return ok, {n: {"value": numbers[n], "limit": limits[n]} for n in limits}


def build_seconds(pool_done: float) -> float:
    """Seconds the program's kernel library took to build in this run: from
    the first warm-up request's start (``pool_done``, seconds since the
    process started) to the write of the newest library the process loaded
    from its checkout; 0 where every one was there before the process
    started."""
    from torch_bench import trace

    started = time.time() - process_age()
    written = [os.stat(lib).st_mtime - started for lib in trace.checkout_libraries(ROOT)]
    written = [t for t in written if t >= 0]
    return max(max(written) - pool_done, 0.0) if written else 0.0


def end_to_end(w: Window, pairs: int, memory_peak: int, setup_s: float) -> dict:
    """The end-to-end metrics' values: pairs completed (requests that did
    not fail, ``pairs`` each) over the window's seconds, the 90th
    percentile of the requests' latencies (a failed one's infinite), the
    device memory's peak over the window in GiB, and set-up's seconds."""
    from torch_bench import stats

    return {"pairs_per_s": (w.attempted - w.failed) * pairs / w.seconds,
            "latency_p90_s": stats.percentile(w.latencies, 90),
            "peak_mem_gib": memory_peak / 2 ** 30,
            "setup_s": setup_s}


def run_cell(spec: dict, workload: str, config: dict, traffic: dict, seed: int, seconds: float,
             trace_on: bool, device) -> dict:
    """Serve the cell for ``seconds`` on ``device`` and return the result
    line's object."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from torch_bench import cells, stats, trace

    cuda = device.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(device)) if cuda else (lambda: None)
    marks = [("imports", process_age())]
    pairs = traffic["pairs_per_request"]
    pool = cells.make_pool(config, traffic, seed, device)
    sync()
    marks.append(("pool", process_age()))
    client = cells.entry(traffic).Client(config, device)
    for i in range(traffic["warmup_requests"]):
        client.request(*pool[i % len(pool)])
        sync()
        marks.append((f"warm-up {i + 1}", process_age()))
    build_s = build_seconds(marks[1][1])
    # The pairs whose answers are checked, drawn from the seed; the latest
    # answer of each is kept.
    checked = set(np.random.default_rng(seed).permutation(len(pool))[:traffic["check_requests"]]
                  .tolist())
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = process_age()
    prof = None
    if trace_on:
        prof = profile(activities=[ProfilerActivity.CPU]
                       + ([ProfilerActivity.CUDA] if cuda else []))
        # The profiler's own start-up lands in a request outside the window.
        prof.start()
        client.request(*pool[0])
        sync()
    w = serve(client, pool, seconds, checked, sync, prof, traffic["trace_seconds"] or seconds,
              pairs, config["dims"])
    memory_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    block_k = client.block_k
    client.close()
    del client
    if cuda:
        torch.cuda.empty_cache()
    log("set-up, seconds since the process started: "
        + ", ".join(f"{name} {t:.2f}" for name, t in marks) + f", window {setup_s:.2f}")
    log(f"kernel library built in this run: {build_s:.2f} s of set-up"
        if build_s else "kernel library built in this run: no (loaded as built before)")
    log(f"requests in the window: {w.attempted} ({w.failed} failed) of {pairs} pair(s) each "
        f"in {w.seconds:.6f} s, "
        f"latency median {stats.percentile(w.latencies, 50):.6f} s")

    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": memory_peak}
    if cuda:
        dev["power_limit"] = power_limit(device.index or 0)
    result = {"correct": False, "attempted": w.attempted, "failed": w.failed}
    metrics = {}
    if trace_on:
        p = profile_of(w, config, block_k, dev["kind"])
        for m in cells.per_layer_metrics(spec, workload):
            value = cells.reader(m["name"]).read(p)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev["busy_s"] = trace.busy_seconds(p)
        dev["window_s"] = p.window[1] - p.window[0]
        result["breakdown"] = trace.breakdown(p)
        log(f"traced {len(p.solves)} requests over {dev['window_s']:.6f} s: "
            f"{len(p.device)} device operations, {len(p.runtime)} runtime calls; "
            f"idle by host span: {trace.idle_by_span(p)}")
    else:
        values = end_to_end(w, pairs, memory_peak, setup_s)
        for m in cells.end_to_end_metrics(spec, workload):
            metrics[m["name"]] = {"value": finite(values[m["name"]]), "unit": m["unit"]}
    result["metrics"] = metrics
    result["device"] = dev
    # Set-up's parts, outside ``metrics``: ``setup_s`` holds the build.
    result["setup"] = {"build_s": build_s, **{name: t for name, t in marks}}
    result["correct"], result["check"] = check(config, pairs, pool, w)
    return result


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    # Any kernel cache the CUDA driver keeps stays inside the checkout.
    os.environ.setdefault("CUDA_CACHE_PATH", str(ROOT / "build" / "cuda_cache"))
    from torch_bench import cells
    spec = cells.load_spec()
    cell, config, traffic = cells.find(spec, args.workload)
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        log(f"this cell needs {cell['chips']} CUDA device(s); "
            f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 1
    torch.set_num_threads(1)
    device = torch.device("cuda", 0)
    result = run_cell(spec, args.workload, config, traffic, args.seed, args.seconds,
                      bool(args.trace), device)
    loaded = sorted({m.split(".")[0] for m in sys.modules} & set(NOT_LOADED))
    if loaded:
        log(f"the run loaded {', '.join(loaded)}: the port runs without JAX; no result")
        return 1
    for name, c in result["check"].items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    # Import the benchmark as the package ``torch_bench`` from the
    # checkout's root, not its modules from the script's own directory.
    sys.path[0] = str(ROOT)
    sys.exit(main())
