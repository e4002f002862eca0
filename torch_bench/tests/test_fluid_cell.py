"""The fluid cell ``slide_fluid_16384.pair`` cut to a size the CPU runs
(``small_cell``): a sound run is correct, a traced one reports its regrids, the
control (the plain fluid reference storing its fields in bfloat16) fails,
and so do a fluid step that returns its state unchanged and an answer
altered where it is produced. Run by hand from the repository root:
``python -m pytest torch_bench/tests -q``."""

import pytest
import torch

from opticalflow2d_tpu_torch.engine import registration, session
from torch_bench import correct
from torch_bench.readings import control_readings
from torch_bench.run import run_cell

WORKLOAD = "slide_fluid_16384.pair"
CPU = torch.device("cpu")
SEED = 2 ** 31 + 177


def _cell(small_cell):
    """The cut cell with a pool of 2, both checked: a request takes about
    half a second here, so the window serves each of them."""
    spec, workload, config, traffic = small_cell(WORKLOAD)
    traffic.update(pool=2)
    return spec, workload, config, traffic


def _run(cell):
    spec, workload, config, traffic = cell
    return run_cell(spec, workload, config, traffic, SEED, 0.5, False, CPU)


def test_sound_fluid_run_is_correct(small_cell, capsys):
    cell = _cell(small_cell)
    r = _run(cell)
    assert r["correct"] and r["failed"] == 0
    assert list(r["check"]) == ["motion_gap_px", "warp_gap", "iters_gap", "regrids_gap"]
    assert all(c["value"] == 0.0 for c in r["check"].values())
    assert "SSD reduction" in capsys.readouterr().err


def test_fluid_control_fails(small_cell):
    _, _, config, traffic = _cell(small_cell)
    numbers = control_readings(config, traffic, SEED, CPU)
    assert not correct.judge(numbers, config["limits"])


def test_fluid_step_returning_its_state_fails(small_cell, monkeypatch):
    def frozen(*args, **kw):
        return lambda u, velocity, g: (u, velocity)

    monkeypatch.setattr(registration, "make_fluid_step", frozen)
    monkeypatch.setattr(registration, "make_fluid_two_pass_step", frozen)
    assert not _run(_cell(small_cell))["correct"]


@pytest.mark.parametrize("where", ("motion", "warp"))
def test_altered_fluid_answer_fails(small_cell, where, monkeypatch):
    cell = _cell(small_cell)
    target = (registration, "compose") if where == "motion" else (session, "warp2d")
    original = getattr(*target)

    def altered(*args):
        out = original(*args).clone()
        out.view(-1)[out.numel() // 3] += 1e-3
        return out

    monkeypatch.setattr(*target, altered)
    assert not _run(cell)["correct"]


def test_a_traced_small_fluid_cell_reports_regrid_ms(small_cell):
    """On the CPU the trace holds no device operation, so the roofline
    finds nothing, while the regrids' spans give ``regrid_ms``: the wall
    time of the program's ``regrid`` spans over the traced requests."""
    from torch_bench import cells, program_spans, run

    captured = []
    original = run.profile_of

    def profile_of(*args, **kw):
        captured.append(original(*args, **kw))
        return captured[-1]

    spec, workload, config, traffic = _cell(small_cell)
    run.profile_of = profile_of
    try:
        result = run.run_cell(spec, workload, config, traffic, SEED, 1.0, True, CPU)
    finally:
        run.profile_of = original
    assert result["correct"]
    p = captured[0]
    assert sum(rg for request in p.solves for _, _, rg in request) > 0
    assert "fluid_iter_roofline" not in result["metrics"]
    records, _ = program_spans.program_records()
    w0, w1 = p.window
    regrids = [r for r in records if r[0] == "regrid" and w0 <= r[1] <= w1]
    assert len(regrids) == sum(rg for request in p.solves for _, _, rg in request)
    want = 1e3 * sum(r[2] for r in regrids) / len(p.solves)
    assert want > 0
    assert result["metrics"]["regrid_ms"]["value"] == pytest.approx(want)
    assert cells.reader("regrid_ms").read(p) == pytest.approx(want)
