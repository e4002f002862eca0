"""What each pair of a cell's pool costs: its latency and its solves, pair by
pair, for several seeds (``slide_fluid_16384.pair`` unless ``--workload``
names another cell of one pair a request).

    python3 probes/pool_pairs.py --seeds N [N ...] --out FILE [--workload NAME] [--reps 2]

A run's ``latency_p90_s`` over a pool of 8 served in turn is its slowest
pair's latency, so a seed whose pool holds one costly pair reads a higher
tail. This probe opens the cell's entry once, warms it on the first pool,
then serves every pair of each seed's pool ``--reps`` times, timed to a
synchronize, and writes one JSON line a request: seed, pair, latency (s),
the displacement peak the generator gave the pair where its data has
``displacement_peak_px``, and the solves ``(scale, iterations, regrids)``
coarse to fine. It prints each seed's slowest pair and a least-squares fit
of latency on the regrids of each level over the pairs that ran every
iteration, beside the card's name and power limit.

Needs one CUDA card; about 15 s a seed at 16384^2.
"""
import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=False).stdout.strip()


def fit(rows: list) -> dict:
    """Least squares of latency on a constant and each level's regrids, over
    the pairs whose solves ran every iteration the settings allow."""
    import numpy as np

    full = max(sum(s[1] for s in r["solves"]) for r in rows)
    rows = [r for r in rows if sum(s[1] for s in r["solves"]) == full]
    x = np.array([[1.0] + [s[2] for s in r["solves"]] for r in rows])
    y = np.array([r["latency_s"] for r in rows])
    coef, *_ = np.linalg.lstsq(x, y, rcond=None)
    scales = [s[0] for s in rows[0]["solves"]]
    return {"pairs": len(rows), "base_s": float(coef[0]),
            "s_a_regrid_by_scale": {int(sc): float(c) for sc, c in zip(scales, coef[1:])},
            "residual_s": float(np.std(y - x @ coef))}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--out", required=True)
    parser.add_argument("--workload", default="slide_fluid_16384.pair")
    parser.add_argument("--reps", type=int, default=2)
    args = parser.parse_args()

    sys.path.insert(0, str(ROOT))
    import torch

    from torch_bench import cells
    from torch_bench.data import synth

    _, config, traffic = cells.find(cells.load_spec(), args.workload)
    if traffic["pairs_per_request"] != 1:
        raise SystemExit(f"{args.workload} serves {traffic['pairs_per_request']} pairs a request")
    dev = torch.device("cuda", 0)
    torch.set_num_threads(1)
    client = cells.entry(traffic).Client(config, dev)
    rows = []
    with open(args.out, "w") as out:
        for i, seed in enumerate(args.seeds):
            peaks = [None] * traffic["pool"]
            if "displacement_peak_px" in config["data"]:
                # The generator's first draw from the seed (data/nuclei_texture.py).
                gen = torch.Generator(device=dev).manual_seed(seed)
                peaks = synth.fixed_set_in_seeded_order(
                    *config["data"]["displacement_peak_px"], traffic["pool"], gen, dev).tolist()
            pool = cells.make_pool(config, traffic, seed, dev)
            if i == 0:
                for p in range(traffic["warmup_requests"]):
                    client.request(*pool[p % len(pool)])
                torch.cuda.synchronize(dev)
            for p, pair in enumerate(pool):
                for rep in range(args.reps):
                    torch.cuda.synchronize(dev)
                    a = time.perf_counter()
                    solves = client.request(*pair)[2]
                    torch.cuda.synchronize(dev)
                    row = {"seed": seed, "pair": p, "rep": rep, "peak_px": peaks[p],
                           "latency_s": time.perf_counter() - a, "solves": solves}
                    rows.append(row)
                    out.write(json.dumps(row) + "\n")
            del pool
            torch.cuda.empty_cache()
    client.close()
    slowest = {}
    for r in rows:
        slowest[r["seed"]] = max(slowest.get(r["seed"], 0.0), r["latency_s"])
    print(json.dumps({"workload": args.workload, "card": card(), "slowest_pair_s": slowest,
                      "fit": fit(rows)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
