"""The correctness comparison fails where it should: the control (the
reference with its fields stored in bfloat16) and each fault a cell can
have, planted in the program underneath a run that skips the look for a
chip; and a sound run passes. A cell on one card has no exchange between
chips, so the faults are a solver step that returns its state unchanged,
an answer altered where it is produced, and, where a request holds a
stack of pairs, half of the stack left out of the solver's launches."""

import pytest
import torch

from opticalflow2d_tpu_torch.engine import registration, session
from opticalflow2d_tpu_torch.kernels._build import Pairs
from torch_bench import correct
from torch_bench.entries import batch
from torch_bench.readings import control_readings
from torch_bench.run import run_cell

CELLS = ("slide_hs_4096.pair", "timelapse_hs_1024.series")
CPU = torch.device("cpu")
# Where each cell's answers are produced: the motion's last compose and the
# warp of the moving image (a module and the name it calls).
PRODUCED = {
    "slide_hs_4096.pair": {"motion": (registration, "compose"), "warp": (session, "warp2d")},
    "timelapse_hs_1024.series": {"motion": (registration, "compose_batch"),
                                 "warp": (batch, "warp2d_batch")},
}


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

    def frozen_block_batch(u, g, alpha, k, pairs, out):
        for p in pairs:
            out[p] = u[p]
        return out, torch.zeros((len(pairs), k, 2), dtype=u.dtype)

    monkeypatch.setattr(registration, "diffusion_block", frozen_block)
    monkeypatch.setattr(registration, "diffusion_block_batch", frozen_block_batch)
    assert not _run(small_cell(workload))["correct"]


def test_half_of_the_stack_left_out_fails(small_cell, monkeypatch):
    """The batched block launches the first half of its pairs and hands
    the rest their start unchanged, with the sums of the last launched."""
    original = registration.diffusion_block_batch

    def half_block(u, g, alpha, k, pairs, out):
        listed = list(pairs)
        kept = listed[:max(len(listed) // 2, 1)]
        out, sums = original(u, g, alpha, k, Pairs(kept, u.shape[0]), out)
        for p in listed[len(kept):]:
            out[p] = u[p]
        return out, torch.cat([sums, sums[-1:].expand(len(listed) - len(kept), -1, -1)])

    monkeypatch.setattr(registration, "diffusion_block_batch", half_block)
    assert not _run(small_cell("timelapse_hs_1024.series"))["correct"]


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("where", ("motion", "warp"))
def test_altered_answer_fails(small_cell, workload, where, monkeypatch):
    cell = small_cell(workload)
    limits = cell[2]["limits"]
    target = PRODUCED[workload][where]
    step = 10 * limits["motion_gap_px" if where == "motion" else "warp_gap"]
    original = getattr(*target)

    def altered(*args):
        out = original(*args).clone()
        out.view(-1)[out.numel() // 3] += step
        return out

    monkeypatch.setattr(*target, altered)
    assert not _run(cell)["correct"]
