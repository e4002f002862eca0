"""Checks of the benchmark's own arithmetic and of its correctness
comparison, on the CPU at small sizes. Run by hand from the repository
root: ``python -m pytest torch_bench/tests -q``."""

import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@pytest.fixture
def small_cell():
    """``(spec, workload, config, traffic)`` of a cell cut to a size the
    CPU runs in a fraction of a second a request; the cell is named
    ``<config>.<traffic>`` by the files it takes."""
    from torch_bench import cells

    spec = cells.load_spec()

    def make(workload: str):
        config_name, traffic_name = workload.split(".")
        config = json.loads((cells.BENCH / "configs" / f"{config_name}.json").read_text())
        traffic = json.loads((cells.BENCH / "traffic" / f"{traffic_name}.json").read_text())
        if max(config["dims"]) > 128:
            config["dims"] = [96, 80]
            config["settings"].update(nscales=2, niter=[60, 60, 60])
        if traffic["pairs_per_request"] > 1:
            traffic["pairs_per_request"] = 3
        traffic.update(pool=4, check_requests=2, warmup_requests=1)
        return spec, workload, config, traffic

    return make
