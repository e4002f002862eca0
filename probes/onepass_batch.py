"""Measure what B10's pair axis costs the single B10 and what it gains over
single launches, on one card.

    python3 probes/onepass_batch.py --parent DIR --out results.jsonl

``DIR`` holds a checkout of another commit (``git archive``), whose kernels
are built beside this checkout's. Each side times its single B10 (the
one-pass Thirion iteration with its Logger sums, kernelwidth 5, as phase 6
of ``chip_smoke.py`` runs it) at 4096^2 in a process of its own, in the
order parent, change, change, parent, parent, change; then this checkout
times B10's pair axis, every pair listed, against as many single launches
at the 4DCT cell's two levels (640 pairs of 512^2 and of 256^2) and on 16
pairs of 1024^2, each beside its bound (24 B a pixel over 3.35 TB/s).
Times are CUDA-event medians of 20 runs of 10 calls after 3 warm-ups (the
single launches: 5 runs of one loop). One JSON line a run. Needs one CUDA
card, about two minutes.
"""
import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
ORDER = ("parent", "change", "change", "parent", "parent", "change")
# sigma_i, sigma_x, sigma_fluid, sigma_diffusion, kernelwidth of the demo's Thirion set.
ARGS = (1.0, 0.25, 2.0, 2.0, 5)
BYTES_PER_PIXEL = 24
HBM_BYTES_PER_S = 3.35e12


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
    """Random reference images, moving images near them and a demons
    estimate of up to 0.4 px on the card: ``[n, n]`` or ``[count, n, n]``."""
    import torch

    lead = () if count is None else (count,)
    rng = np.random.default_rng(seed)
    dev = torch.device("cuda", 0)
    iref = torch.from_numpy(rng.random(lead + (n, n), dtype=np.float32)).to(dev)
    iaux = torch.roll(iref, (1, 2), (-2, -1)).contiguous()
    u = torch.from_numpy(rng.normal(0, 1, lead + (2, n, n)).astype(np.float32)).to(dev)
    return iaux, iref, (torch.tanh(u) * 0.4).contiguous()


def single(label: str) -> dict:
    """This process's package (``sys.path[0]``): its single B10."""
    from opticalflow2d_tpu_torch.kernels import _build
    from opticalflow2d_tpu_torch.kernels.demons_onepass import thirion_onepass

    _build.build()
    iaux, iref, u = inputs(4096, None)
    return {"run": "single", "side": label, "shape": [4096, 4096],
            "demons_onepass_ms": median_ms(
                lambda: thirion_onepass(iaux, iref, u, *ARGS, False, True))}


def batched() -> list:
    """This checkout's B10 pair axis against single launches."""
    import torch

    from opticalflow2d_tpu_torch import kernels
    from opticalflow2d_tpu_torch.kernels import _build
    from opticalflow2d_tpu_torch.kernels.demons_onepass import (
        thirion_onepass, thirion_onepass_batch)

    out = []
    for count, n in ((640, 512), (640, 256), (16, 1024)):
        iaux, iref, u = inputs(n, count)
        pairs = _build.Pairs(range(count), count)
        new = torch.empty_like(u)
        kernels.reset_launches()
        thirion_onepass_batch(iaux, iref, u, *ARGS, False, pairs, new)
        launches = kernels.LAUNCHES["demons_onepass_batch"]
        bound_ms = BYTES_PER_PIXEL * count * n * n / HBM_BYTES_PER_S * 1e3
        ms = median_ms(lambda: thirion_onepass_batch(iaux, iref, u, *ARGS, False, pairs, new))
        singles = median_ms(lambda: [thirion_onepass(iaux[p], iref[p], u[p], *ARGS, False, True)
                                     for p in range(count)], runs=5, batch=1)
        out.append({"run": "batched", "kernel": "demons_onepass_batch",
                    "shape": [count, n, n], "batched_ms": ms, "singles_ms": singles,
                    "bound_ms": bound_ms, "roofline_pct": 100 * bound_ms / ms,
                    "launches_a_call": launches})
        del iaux, iref, u, new
        torch.cuda.empty_cache()
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--side", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.side:  # one timed side, in a process of its own
        print(json.dumps(single(args.side)), flush=True)
        return
    import torch

    roots = {"parent": str(Path(args.parent).resolve()), "change": str(ROOT)}
    build = ("import sys; sys.path.insert(0, sys.argv[1]); "
             "from opticalflow2d_tpu_torch.kernels import _build; _build.build()")
    builds = [subprocess.Popen([sys.executable, "-c", build, root]) for root in roots.values()]
    if any(p.wait() for p in builds):
        raise SystemExit("a build failed")
    card = torch.cuda.get_device_name(0)
    with open(args.out, "w") as f:
        for side in ORDER:
            code = (f"import sys; sys.path.insert(0, {roots[side]!r}); "
                    f"sys.argv = ['onepass_batch', '--parent', '', '--out', '', "
                    f"'--side', {side!r}]; "
                    f"import runpy; runpy.run_path({str(Path(__file__).resolve())!r}, "
                    f"run_name='__main__')")
            line = subprocess.run([sys.executable, "-c", code], check=True, capture_output=True,
                                  text=True).stdout.strip().splitlines()[-1]
            rec = dict(json.loads(line), card=card)
            print(json.dumps(rec), flush=True)
            f.write(json.dumps(rec) + "\n")
        sys.path.insert(0, str(ROOT))
        for rec in batched():
            rec["card"] = card
            print(json.dumps(rec), flush=True)
            f.write(json.dumps(rec) + "\n")


if __name__ == "__main__":
    main()
