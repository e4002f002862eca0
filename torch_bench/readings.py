#!/usr/bin/env python3
"""The readings a cell's correctness limits are set from, in one process.

    python3 torch_bench/readings.py --workload <name> --seconds <s> \
        --seeds <n> ... [--control-seeds <n> ...] [--out FILE]

For each of ``--seeds`` it runs the cell as ``run.py`` does, with a window
of ``--seconds`` (the program's readings: sound runs give the lower
reading of each number). For each of ``--control-seeds`` it makes the
same pool, checks the same pairs (every pair of a stacked request), and
compares the control (the reference with its fields stored in bfloat16,
``correct.py``) with the reference: the upper reading. One JSON line a
reading. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def control_readings(config: dict, traffic: dict, seed: int, device) -> dict:
    """The control's numbers over the pairs a run of ``seed`` checks."""
    import numpy as np

    from torch_bench import cells, correct

    pool = cells.make_pool(config, traffic, seed, device)
    checked = np.random.default_rng(seed).permutation(len(pool))[:traffic["check_requests"]]
    readings = []
    for p in sorted(checked.tolist()):
        for iref, imov in correct.split(pool[p], traffic["pairs_per_request"]):
            expected = correct.reference_answer(config, iref, imov)
            readings.append(correct.gaps(correct.reference_answer(config, iref, imov,
                                                                  control=True), expected))
    return correct.worst(readings)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seconds", type=float, default=3.0)
    parser.add_argument("--seeds", type=int, nargs="*", default=[])
    parser.add_argument("--control-seeds", type=int, nargs="*", default=[])
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)

    import torch

    from torch_bench import cells
    from torch_bench.run import run_cell

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    spec = cells.load_spec()
    _, config, traffic = cells.find(spec, args.workload)
    out = open(args.out, "a") if args.out else None
    try:
        for kind, seeds in (("program", args.seeds), ("control", args.control_seeds)):
            for seed in seeds:
                if kind == "program":
                    r = run_cell(spec, args.workload, config, traffic, seed, args.seconds, False,
                                 device)
                    numbers = {n: c["value"] for n, c in r["check"].items()}
                    numbers["correct"] = r["correct"]
                else:
                    numbers = control_readings(config, traffic, seed, device)
                line = json.dumps({"workload": args.workload, "kind": kind, "seed": seed,
                                   **numbers})
                print(line, flush=True)
                if out:
                    out.write(line + "\n")
                    out.flush()
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    # Import the benchmark as the package ``torch_bench`` from the
    # checkout's root, not its modules from the script's own directory.
    sys.path[0] = str(ROOT)
    sys.exit(main())
