"""Where the program's memory peaks in a request of a cell
(``slide_hs_4096.pair`` unless ``--workload`` names another of one pair a
request), and what the level loop's motion upsample costs on the card, for
one checkout.

    python3 probes/upsample_motion.py --seed N --out FILE [--root DIR] [--workload NAME]

``--root`` imports the program and the benchmark from another checkout (a
parent unpacked with ``git archive`` under ``build/parent/``); the default
is this one. Runs the cell as ``torch_bench/run.py`` holds it (the pool of
8 pairs made from the seed, one session, two warm-up requests, the answers
of two pool pairs kept) and prints one JSON line:

- ``peak_by_span_gib``: ``torch.cuda.max_memory_allocated()`` over each
  stretch of ``--requests`` requests between two span boundaries, by the
  innermost program span open in it (``outside`` where none is): the
  allocator's peak is read and reset at every start and end of a span of
  ``engine/registration.py``, whose ``span`` and ``entry`` the probe wraps
  from outside; ``peak_gib`` the largest;
- ``upsample``: the four ``upsample_motion`` calls of one request, their
  inputs captured from the level loop and replayed under ``torch.profiler``
  (three times; the last): each call's device time (the sum of its kernels',
  copies' and sets' durations), device operations and host wall time to a
  synchronize, and their sums a request; the runtime's synchronising calls
  a request; and ``LAUNCHES["upsample_motion"]`` where the checkout counts
  it;
- with ``--times``, where the checkout's ``chip_smoke.py`` has it, phase 6's
  ``upsample_times`` (the kernel against its plain version at 2048^2 and
  256^2 -> 4096^2, CUDA-event medians);
- the card's name and power limit.

Needs one CUDA card, about a minute.
"""
import argparse
import contextlib
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=False).stdout.strip()


class PeakBySpan:
    """Reads and resets the allocator's peak at each span boundary and
    files it under the innermost span open before the boundary."""

    def __init__(self, torch):
        self.torch = torch
        self.stack = []
        self.peaks = {}

    def mark(self):
        t = self.torch.cuda
        name = self.stack[-1] if self.stack else "outside"
        self.peaks[name] = max(self.peaks.get(name, 0), t.max_memory_allocated())
        t.reset_peak_memory_stats()

    def wrap(self, original):
        @contextlib.contextmanager
        def wrapped(name, *args, **kwargs):
            self.mark()
            self.stack.append(name)
            try:
                with original(name, *args, **kwargs):
                    yield
            finally:
                self.mark()
                self.stack.pop()
        return wrapped


def device_ops(prof) -> tuple:
    """``(device, runtime)`` records of a profile (``torch_bench.trace``)."""
    from torch_bench import trace

    device, runtime, _ = trace.reduce_events(prof.profiler.kineto_results.events())
    return device, runtime


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", default=str(ROOT))
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--requests", type=int, default=4)
    parser.add_argument("--workload", default="slide_hs_4096.pair")
    parser.add_argument("--times", action="store_true")
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))

    import time

    import torch
    from torch.profiler import ProfilerActivity, profile

    from opticalflow2d_tpu_torch import kernels
    from opticalflow2d_tpu_torch.engine import registration
    from torch_bench import cells, trace

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    torch.set_num_threads(1)
    dev = torch.device("cuda", 0)
    spec = cells.load_spec()
    _, config, traffic = cells.find(spec, args.workload)
    pool = cells.data_generator(config).make_pool(config["data"], tuple(config["dims"]),
                                                  traffic["pool"], args.seed, dev)
    client = cells.entry(traffic).Client(config, dev)
    for i in range(traffic["warmup_requests"]):
        client.request(*pool[i % len(pool)])
    torch.cuda.synchronize()

    peaks = PeakBySpan(torch)
    registration.span = peaks.wrap(registration.span)
    registration.entry = peaks.wrap(registration.entry)
    calls = []
    upsample = registration.upsample_motion

    def capture(u, dimout):
        calls.append((u.clone(), tuple(dimout)))
        return upsample(u, dimout)

    kept = {}
    torch.cuda.reset_peak_memory_stats()
    for r in range(args.requests):
        kept[r % 2] = client.request(*pool[r % len(pool)])
        torch.cuda.synchronize()
    peaks.mark()
    peak_by_span = {n: p / 2 ** 30 for n, p in sorted(peaks.peaks.items())}

    registration.upsample_motion = capture
    client.request(*pool[0])
    registration.upsample_motion = upsample
    counted = "upsample_motion" in kernels.LAUNCHES
    for _ in range(3):  # the last of three replays is kept
        kernels.reset_launches()
        per_call = []
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for u, dimout in calls:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                upsample(u, dimout)
                torch.cuda.synchronize()
                per_call.append({"source": list(u.shape[1:]), "target": list(dimout),
                                 "wall_ms": 1e3 * (time.perf_counter() - t0)})
        launches = kernels.LAUNCHES["upsample_motion"] if counted else None
    device, runtime = device_ops(prof)
    device_ms = 1e3 * sum(d for _, _, d, _ in device)
    syncs = sum(1 for n, *_ in runtime if n in trace.SYNC_CALLS)
    line = {
        "root": str(root), "workload": args.workload, "seed": args.seed, "card": card(),
        "requests": args.requests,
        "peak_gib": max(peak_by_span.values()),
        "peak_by_span_gib": peak_by_span,
        "upsample": {
            "calls": per_call,
            "device_ms_a_request": device_ms,
            "device_ops_a_request": len(device),
            "kernels_a_request": sum(1 for *_, k in device if k == "kernel"),
            "wall_ms_a_request": sum(c["wall_ms"] for c in per_call),
            "sync_calls_a_request": syncs,
            "of_which_the_probe_s_own": 2 * len(calls),
            "launches_upsample_motion": launches,
            "top_device_ops": top(device),
        },
    }
    if args.times:
        import chip_smoke
        if hasattr(chip_smoke, "upsample_times"):
            line["times"] = chip_smoke.upsample_times(dev)
    client.close()
    text = json.dumps(line)
    print(text, flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(text + "\n")
    return 0


def top(device: list, n: int = 8) -> list:
    by = {}
    for name, _, d, _ in device:
        c, t = by.get(name[:80], (0, 0.0))
        by[name[:80]] = (c + 1, t + d)
    return [[k, c, 1e3 * t] for k, (c, t) in sorted(by.items(), key=lambda kv: -kv[1][1])[:n]]


if __name__ == "__main__":
    sys.exit(main())
