"""The correctness comparison fails where it should: the control (the
reference with its fields stored in bfloat16) and each fault a cell can
have, planted in the program underneath a run that skips the look for a
chip; and a sound run passes. A cell on one card has no exchange between
chips, and one pair a request has no batch to halve, so the faults are a
solver step that returns its state unchanged and an answer altered where
it is produced."""

import pytest
import torch

from opticalflow2d_tpu_torch.engine import registration, session
from torch_bench import correct
from torch_bench.readings import control_readings
from torch_bench.run import run_cell

CELLS = ("slide_hs_4096.pair",)
CPU = torch.device("cpu")


def _run(cell):
    spec, workload, config, traffic = cell
    return run_cell(spec, workload, config, traffic, 2 ** 31 + 77, 0.5, False, CPU)


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(small_cell, workload):
    cell = small_cell(workload)
    r = _run(cell)
    assert r["correct"] and r["failed"] == 0
    assert list(r["check"]) == list(cell[2]["limits"])


@pytest.mark.parametrize("workload", CELLS)
def test_control_fails(small_cell, workload):
    _, _, config, traffic = small_cell(workload)
    numbers = control_readings(config, traffic, 2 ** 31 + 77, CPU)
    assert not correct.judge(numbers, config["limits"])


@pytest.mark.parametrize("workload", CELLS)
def test_step_returning_its_state_fails(small_cell, workload, monkeypatch):
    def frozen_block(u, g, alpha, k):
        return u.clone(), torch.zeros((k, 2), dtype=u.dtype)

    monkeypatch.setattr(registration, "diffusion_block", frozen_block)
    assert not _run(small_cell(workload))["correct"]


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("where", ("motion", "warp"))
def test_altered_answer_fails(small_cell, workload, where, monkeypatch):
    cell = small_cell(workload)
    limits = cell[2]["limits"]
    target = (registration, "compose") if where == "motion" else (session, "warp2d")
    step = 10 * limits["motion_gap_px" if where == "motion" else "warp_gap"]
    original = getattr(*target)

    def altered(a, b):
        out = original(a, b).clone()
        out.view(-1)[out.numel() // 3] += step
        return out

    monkeypatch.setattr(*target, altered)
    assert not _run(cell)["correct"]
