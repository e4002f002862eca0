"""What each pair of a cell's pool costs: its latency and its solves, pair by
pair, for several seeds (``slide_fluid_16384.pair`` unless ``--workload``
names another cell); for a cell of many pairs a request, what each request
of the pool costs and the work it holds.

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

For a cell of many pairs a request (``dirlab_fluid.volume``), a line a
request holds, per scale coarse to fine, the host reads (the largest
iteration count of its pairs), the pair-iterations, the regrids and the
pairs that ran to the niter cap by phase (pairs ``k`` of ``slices`` a
phase, phase-major). It prints each seed's rate (pairs over the mean
latency of its pool) beside the mean work of its pool, and a least-squares
fit of latency on the reads and on the pair-iterations and regrids
weighted by each level's megapixels: how much of the seeds' spread the
work explains.

Needs one CUDA card; about 15 s a seed at 16384^2, 30 s a seed for the
4DCT cell.
"""
import argparse
import json
import statistics
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


def request_work(solves: list, traffic: dict, config: dict, niter) -> dict:
    """A request's work per scale, from ``solves`` (``(scale, iterations,
    regrids)`` pair by pair, each pair's coarse to fine); ``niter[scale]``
    the cap."""
    from opticalflow2d_tpu_torch.ops.resample import pyramid_dims

    s = config["settings"]
    dims = pyramid_dims(tuple(config["dims"]), s["nscales"])
    slices = config["data"].get("slices", traffic["pairs_per_request"])
    by_scale = {}
    for k, scale_its_regrids in enumerate(_by_pair(solves, traffic["pairs_per_request"])):
        for scale, its, regrids in scale_its_regrids:
            w = by_scale.setdefault(int(scale), {"reads": 0, "pair_iterations": 0, "regrids": 0,
                                                 "at_cap_by_phase": {}})
            w["reads"] = max(w["reads"], its)
            w["pair_iterations"] += its
            w["regrids"] += regrids
            if its == int(niter[int(scale)]):
                phase = str(k // slices)
                w["at_cap_by_phase"][phase] = w["at_cap_by_phase"].get(phase, 0) + 1
    mpx = {sc: dims[sc][0] * dims[sc][1] / 1e6 for sc in by_scale}
    return {"by_scale": by_scale,
            "reads": sum(w["reads"] for w in by_scale.values()),
            "mpx_iterations": sum(w["pair_iterations"] * mpx[sc] for sc, w in by_scale.items()),
            "mpx_regrids": sum(w["regrids"] * mpx[sc] for sc, w in by_scale.items())}


def _by_pair(solves: list, pairs: int) -> list:
    """``solves`` cut into each pair's list (the entry lists pair 0's
    solves first)."""
    each = len(solves) // pairs
    return [solves[k * each:(k + 1) * each] for k in range(pairs)]


def spread_of(values: list) -> float:
    """The distance between the first and the third quartile over the
    median."""
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2


def fit_requests(rows: list, pairs: int) -> dict:
    """Each seed's rate and mean work, and a least-squares fit of a
    request's latency on a constant, its reads, and its megapixel
    iterations and regrids, over every request."""
    import numpy as np

    seeds = sorted({r["seed"] for r in rows})
    per_seed = {}
    for seed in seeds:
        mine = [r for r in rows if r["seed"] == seed]
        per_seed[seed] = {
            "pairs_per_s": pairs / float(np.mean([r["latency_s"] for r in mine])),
            **{key: float(np.mean([r["work"][key] for r in mine]))
               for key in ("reads", "mpx_iterations", "mpx_regrids")}}
    x = np.array([[1.0, r["work"]["reads"], r["work"]["mpx_iterations"],
                   r["work"]["mpx_regrids"]] for r in rows])
    y = np.array([r["latency_s"] for r in rows])
    coef, *_ = np.linalg.lstsq(x, y, rcond=None)
    for seed in seeds:
        mine = [i for i, r in enumerate(rows) if r["seed"] == seed]
        per_seed[seed]["fit_pairs_per_s"] = pairs / float(np.mean(x[mine] @ coef))
    spread = {key: spread_of([v[key] for v in per_seed.values()])
              for key in ("pairs_per_s", "fit_pairs_per_s", "mpx_iterations", "reads")}
    return {"per_seed": per_seed, "spread": spread,
            "coef": {"base_s": float(coef[0]), "s_a_read": float(coef[1]),
                     "s_a_mpx_iteration": float(coef[2]), "s_a_mpx_regrid": float(coef[3])},
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
    many = traffic["pairs_per_request"] > 1
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
                           "latency_s": time.perf_counter() - a}
                    if many:
                        row["work"] = request_work(solves, traffic, config, client.config.niter)
                    else:
                        row["solves"] = solves
                    rows.append(row)
                    out.write(json.dumps(row) + "\n")
            del pool
            torch.cuda.empty_cache()
    client.close()
    slowest = {}
    for r in rows:
        slowest[r["seed"]] = max(slowest.get(r["seed"], 0.0), r["latency_s"])
    fitted = fit_requests(rows, traffic["pairs_per_request"]) if many else fit(rows)
    print(json.dumps({"workload": args.workload, "card": card(), "slowest_pair_s": slowest,
                      "fit": fitted}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
