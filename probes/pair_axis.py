"""Measure what the pair axis (B1-B4 batched) costs the single-pair kernels
and what it gains over single launches, on one card.

    python3 probes/pair_axis.py --parent DIR --out results.jsonl

``DIR`` holds a checkout of another commit (``git archive``), whose kernels
are built beside this checkout's. Each side times its single-pair B1 (k =
8), B2, B3 (warp and compose) and B4 at 4096^2 in a process of its own, in
the order parent, change, change, parent, parent, change; then this
checkout times each batched kernel on 16 pairs of 1024^2, every pair
listed, against 16 single launches of its kernel. Times are CUDA-event
medians of 20 runs of 10 calls after 3 warm-ups. One JSON line a run.
Needs one CUDA card.

    python3 probes/pair_axis.py --one-pair --out results.jsonl

times this checkout's B1 (k = 8), B2, B3 and B4 at 4096^2 through their
single entry against their pair-axis entry on a stack of one pair, as the
level loop calls them (a fresh output a call), in turns single, stack,
stack, single, four rounds; and the host time a call of each at 256^2,
the launches queued without a sync (median of 20 runs of 50 calls).
"""
import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
ORDER = ("parent", "change", "change", "parent", "parent", "change")


def median_ms(fn, runs: int = 20, warmup: int = 3, batch: int = 10) -> float:
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(batch):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / batch)
    return float(np.median(times))


def inputs(n: int, count: int | None, seed: int = 1):
    """Random images, their derivatives and fields on the card:
    ``[n, n]`` or ``[count, n, n]``."""
    import torch

    from opticalflow2d_tpu_torch.solvers.base import derivatives

    lead = () if count is None else (count,)
    rng = np.random.default_rng(seed)
    dev = torch.device("cuda", 0)
    iref = torch.from_numpy(rng.random(lead + (n, n), dtype=np.float32)).to(dev)
    imov = torch.roll(iref, (1, 2), (-2, -1)).contiguous()
    d = derivatives(iref, imov)
    g = torch.cat([d.grad_i, d.it.unsqueeze(-3)], dim=-3).contiguous()
    u = torch.from_numpy(rng.normal(0, 1, lead + (2, n, n)).astype(np.float32)).to(dev)
    return imov, g, u, (torch.tanh(u) * 0.4).contiguous()


def single(label: str) -> dict:
    """This process's package (``sys.path[0]``): its single-pair kernels."""
    from opticalflow2d_tpu_torch.kernels import _build
    from opticalflow2d_tpu_torch.kernels.diffusion_block import diffusion_block
    from opticalflow2d_tpu_torch.kernels.diffusion_fused import diffusion_step_fused
    from opticalflow2d_tpu_torch.kernels.logger_norms import logger_norms
    from opticalflow2d_tpu_torch.kernels.warp_fused import compose, warp2d

    _build.build()
    imov, g, u, v = inputs(4096, None)
    out = {"run": "single", "side": label, "shape": [4096, 4096]}
    for name, fn in (("diffusion_block", lambda: diffusion_block(u, g, 0.1, 8)),
                     ("diffusion_step", lambda: diffusion_step_fused(u, g[:2], g[2], 0.1)),
                     ("warp2d", lambda: warp2d(imov, u)), ("compose", lambda: compose(u, u)),
                     ("logger_norms", lambda: logger_norms(u, v))):
        out[name] = median_ms(fn)
    return out


def batched() -> list:
    """This checkout's batched kernels on 16 pairs of 1024^2 against 16
    single launches."""
    import torch

    from opticalflow2d_tpu_torch.kernels import _build
    from opticalflow2d_tpu_torch.kernels.diffusion_block import (
        diffusion_block, diffusion_block_batch)
    from opticalflow2d_tpu_torch.kernels.diffusion_fused import (
        diffusion_step_batch, diffusion_step_fused)
    from opticalflow2d_tpu_torch.kernels.logger_norms import logger_norms, logger_norms_batch
    from opticalflow2d_tpu_torch.kernels.warp_fused import (
        compose, compose_batch, warp2d, warp2d_batch)

    count = 16
    imov, g, u, v = inputs(1024, count)
    pairs = _build.Pairs(range(count), count)
    out = torch.empty_like(u)
    every = range(count)
    runs = {
        "diffusion_block": (lambda: diffusion_block_batch(u, g, 0.1, 8, pairs, out),
                            lambda: [diffusion_block(u[p], g[p], 0.1, 8) for p in every]),
        "diffusion_step": (lambda: diffusion_step_batch(u, g, 0.1, pairs, out),
                           lambda: [diffusion_step_fused(u[p], g[p, :2], g[p, 2], 0.1)
                                    for p in every]),
        "warp2d": (lambda: warp2d_batch(imov, u, pairs),
                   lambda: [warp2d(imov[p], u[p]) for p in every]),
        "compose": (lambda: compose_batch(u, v, pairs, out),
                    lambda: [compose(u[p], v[p]) for p in every]),
        "logger_norms": (lambda: logger_norms_batch(u, v, pairs),
                         lambda: [logger_norms(u[p], v[p]) for p in every]),
    }
    return [{"run": "batched", "kernel": name, "shape": [count, 1024, 1024],
             "batched_ms": median_ms(kern), "singles_ms": median_ms(singles)}
            for name, (kern, singles) in runs.items()]


def host_us(fn, runs: int = 20, warmup: int = 5, batch: int = 50) -> float:
    """Median host microseconds a call, the calls queued without a sync."""
    import time

    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        for _ in range(batch):
            fn()
        times.append((time.perf_counter() - t0) / batch * 1e6)
        torch.cuda.synchronize()
    return float(np.median(times))


def one_pair() -> list:
    """This checkout's single entries against the pair-axis entries on a
    stack of one pair: device ms at 4096^2 in rounds, host us at 256^2."""
    import torch

    from opticalflow2d_tpu_torch.kernels import _build
    from opticalflow2d_tpu_torch.kernels.diffusion_block import (
        diffusion_block, diffusion_block_batch)
    from opticalflow2d_tpu_torch.kernels.diffusion_fused import (
        diffusion_step_batch, diffusion_step_fused)
    from opticalflow2d_tpu_torch.kernels.logger_norms import logger_norms, logger_norms_batch
    from opticalflow2d_tpu_torch.kernels.warp_fused import (
        compose, compose_batch, warp2d, warp2d_batch)

    _build.build()
    one = _build.Pairs([0], 1)

    def runs(n):
        imov, g, u, v = inputs(n, None)
        i1, g1, u1, v1 = imov[None], g[None], u[None], v[None]
        return {
            "diffusion_block": (lambda: diffusion_block(u, g, 0.1, 8),
                                lambda: diffusion_block_batch(u1, g1, 0.1, 8, one,
                                                              torch.empty_like(u1))),
            "diffusion_step": (lambda: diffusion_step_fused(u, g[:2], g[2], 0.1),
                               lambda: diffusion_step_batch(u1, g1, 0.1, one,
                                                            torch.empty_like(u1))),
            "warp2d": (lambda: warp2d(imov, u),
                       lambda: warp2d_batch(i1, u1, one, torch.empty_like(i1))),
            "compose": (lambda: compose(u, v),
                        lambda: compose_batch(u1, v1, one, torch.empty_like(u1))),
            "logger_norms": (lambda: logger_norms(v, u),
                             lambda: logger_norms_batch(v1, u1, one)),
        }

    out = []
    for name, (single_fn, stack_fn) in runs(4096).items():
        rec = {"run": "one_pair", "kernel": name, "shape": [4096, 4096],
               "single_ms": [], "stack_ms": []}
        for _ in range(4):
            for side in ("single", "stack", "stack", "single"):
                rec[f"{side}_ms"].append(median_ms(single_fn if side == "single" else stack_fn))
        out.append(rec)
    for name, (single_fn, stack_fn) in runs(256).items():
        out.append({"run": "one_pair_host", "kernel": name, "shape": [256, 256],
                    "single_us": [host_us(single_fn), host_us(single_fn)],
                    "stack_us": [host_us(stack_fn), host_us(stack_fn)]})
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent")
    ap.add_argument("--out", required=True)
    ap.add_argument("--one-pair", action="store_true")
    ap.add_argument("--side", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one_pair:
        import torch

        sys.path.insert(0, str(ROOT))
        with open(args.out, "w") as f:
            for rec in one_pair():
                rec["card"] = torch.cuda.get_device_name(0)
                print(json.dumps(rec), flush=True)
                f.write(json.dumps(rec) + "\n")
        return
    if not args.parent:
        ap.error("--parent is required without --one-pair")
    if args.side:  # one timed side, in a process of its own
        print(json.dumps(single(args.side)), flush=True)
        return
    roots = {"parent": str(Path(args.parent).resolve()), "change": str(ROOT)}
    build = ("import sys; sys.path.insert(0, sys.argv[1]); "
             "from opticalflow2d_tpu_torch.kernels import _build; _build.build()")
    builds = [subprocess.Popen([sys.executable, "-c", build, root]) for root in roots.values()]
    if any(p.wait() for p in builds):
        raise SystemExit("a build failed")
    with open(args.out, "w") as f:
        for side in ORDER:
            code = (f"import sys; sys.path.insert(0, {roots[side]!r}); "
                    f"sys.argv = ['pair_axis', '--parent', '', '--out', '', '--side', {side!r}]; "
                    f"import runpy; runpy.run_path({str(Path(__file__).resolve())!r}, "
                    f"run_name='__main__')")
            line = subprocess.run([sys.executable, "-c", code], check=True, capture_output=True,
                                  text=True).stdout.strip().splitlines()[-1]
            print(line, flush=True)
            f.write(line + "\n")
        sys.path.insert(0, str(ROOT))
        for rec in batched():
            print(json.dumps(rec), flush=True)
            f.write(json.dumps(rec) + "\n")


if __name__ == "__main__":
    main()
