"""Finding what a cell needs by the names ``BENCHMARK.json`` gives: its
configuration file, its traffic file, the data generator and entry they
name, the plain reference of the configuration's method and the readers
of the per-layer metrics. Each lives in a file of its own, so a cell, a
configuration, a traffic mix or a metric is added by adding files."""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
BENCH = Path(__file__).resolve().parent


def load_spec() -> dict:
    path = ROOT / "BENCHMARK.json"
    if not path.exists():
        raise FileNotFoundError(f"no BENCHMARK.json at {ROOT}")
    return json.loads(path.read_text())


def find(spec: dict, workload: str):
    """``(cell, config, traffic)`` of the workload named ``workload``."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; have {sorted(cells)}")
    cell = cells[workload]
    entry = {c["name"]: c for c in spec["configs"]}[cell["config"]]
    config = json.loads((ROOT / entry["file"]).read_text())
    traffic = json.loads((BENCH / "traffic" / f"{cell['traffic']}.json").read_text())
    return cell, config, traffic


def data_generator(config: dict):
    return importlib.import_module(f"torch_bench.data.{config['data']['kind']}")


def stack_shape(pairs: int, dims, *inner) -> tuple:
    """The shape of a request's field of ``inner + dims`` per pair: as it
    is for one pair a request, under a leading axis of ``pairs`` for more."""
    return (() if pairs == 1 else (pairs,)) + tuple(inner) + tuple(dims)


def make_pool(config: dict, traffic: dict, seed: int, device) -> list:
    """The cell's pool of requests, made from the seed by the data
    generator: entries ``(iref, imov)``, each ``stack_shape(P, dims)`` for
    the traffic's ``P = pairs_per_request``. Refuses an entry of another
    shape."""
    pairs, dims = traffic["pairs_per_request"], tuple(config["dims"])
    pool = data_generator(config).make_pool(config["data"], dims, traffic["pool"], seed, device,
                                            pairs)
    shape = stack_shape(pairs, dims)
    for i, entry in enumerate(pool):
        shapes = [tuple(t.shape) for t in entry]
        if shapes != [shape, shape]:
            raise ValueError(f"pool entry {i} holds {shapes}; {pairs} pair(s) a request of "
                             f"{list(dims)} need (iref, imov) of {shape} each")
    return pool


def entry(traffic: dict):
    return importlib.import_module(f"torch_bench.entries.{traffic['entry']}")


def reference(config: dict):
    return importlib.import_module(f"torch_bench.reference.{config['method']}")


def reader(metric: str):
    """The module ``metrics/<metric>.py`` (a name may hold dots)."""
    path = BENCH / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"torch_bench.metrics.{metric}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def per_layer_metrics(spec: dict, workload: str) -> list:
    """The per-layer metrics this cell reports: those that list it, and
    those with no ``workloads`` list."""
    return [m for m in spec["per_layer"] if workload in m.get("workloads", [workload])]


def end_to_end_metrics(spec: dict, workload: str) -> list:
    return [m for m in spec["end_to_end"] if workload in m.get("workloads", [workload])]
