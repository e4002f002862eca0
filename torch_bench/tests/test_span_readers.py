"""The readers of the program's spans (``program_spans.py`` and the four
metrics over it) on a made-up profile whose answers are known, on the
cases where they must find nothing, and on a traced run of a small cell on
the CPU. Run by hand from the repository root: ``python -m pytest
torch_bench/tests -q``."""

import pytest
import torch

from torch_bench import cells, program_spans, trace

PEAKS = {"hbm_bytes_per_s": 3.35e12}
NEW = ("entry_own_ms", "loop_idle_pct", "ops_idle_pct", "stray_syncs_per_request")

# [name, start_s, dur_s, parent, request, attrs]: one request, as the
# program records it. Window 0 .. 1.
RECORDS = [
    ["register", 0.00, 0.80, -1, 1, None],                            # 0
    ["pyramid", 0.02, 0.08, 0, 1, None],                              # 1
    ["solve", 0.10, 0.50, 0, 1, {"scale": 0, "refine": 0, "nx": 64, "ny": 64}],  # 2
    ["derive", 0.10, 0.05, 2, 1, None],                               # 3
    ["read", 0.30, 0.10, 2, 1, {"site": "block"}],                    # 4
    ["recompute", 0.40, 0.05, 2, 1, None],                            # 5
    ["compose", 0.50, 0.05, 2, 1, None],                              # 6
    ["gc", 0.56, 0.02, 2, 1, {"generation": 2}],                      # 7
    ["upsample", 0.65, 0.10, 0, 1, None],                             # 8
    ["get_motion", 0.80, 0.01, -1, 1, None],                          # 9
    ["warp", 0.81, 0.19, -1, 1, None],                                # 10
]


def made_up():
    return trace.Profile(
        device=[["void diffusion_block_kernel<8, true>(float const*, float*)", 0.15, 0.15,
                 "kernel"],
                ["void at::native::vectorized_elementwise_kernel<4, float>(int)", 0.45, 0.05,
                 "kernel"],
                ["void gather_kernel<1>(float const*)", 0.85, 0.10, "kernel"]],
        runtime=[["cudaMemcpy", 0.05, 0.001],              # pyramid: stray
                 ["cudaLaunchKernel", 0.2, 0.001],
                 ["cudaStreamSynchronize", 0.35, 0.01],    # read: not stray
                 ["cudaStreamSynchronize", 0.59, 0.001],   # solve's own code: stray
                 ["cudaStreamSynchronize", 0.70, 0.001],   # upsample: stray
                 ["cudaStreamSynchronize", 0.90, 0.001]],  # warp: outside register
        spans=[["bench.request", 0.0, 1.0], ["bench.register", 0.0, 0.8],
               ["bench.get_motion", 0.8, 0.01], ["bench.warp", 0.81, 0.19]],
        window=(0.0, 1.0), solves=[[[0, 16, 0]]], dims=[64, 64], nscales=0, block_k=8,
        library_kernels=["diffusion_block_kernel", "gather_kernel"], peaks=PEAKS)


@pytest.fixture
def program(monkeypatch):
    """Make the readers find ``records`` (and ``dropped``) as the program's."""
    def use(records, dropped=0):
        monkeypatch.setattr(program_spans, "program_records", lambda: (records, dropped))
    return use


def _read(name, p):
    return cells.reader(name).read(p)


def test_readers_on_made_up_spans(program, capsys):
    program(RECORDS)
    p = made_up()
    # Self time: register 0.8 - 0.08 - 0.5 - 0.1, get_motion 0.01, warp 0.19.
    assert _read("entry_own_ms", p) == pytest.approx(1e3 * (0.12 + 0.01 + 0.19))
    # Idle 0 .. 0.15, 0.30 .. 0.45, 0.50 .. 0.85, 0.95 .. 1: the loop's
    # share is solve's own 0.55 .. 0.56 and 0.58 .. 0.60, read, recompute.
    assert _read("loop_idle_pct", p) == pytest.approx(100 * (0.03 + 0.10 + 0.05))
    assert _read("ops_idle_pct", p) == pytest.approx(100 * (0.08 + 0.05 + 0.05 + 0.10))
    assert _read("stray_syncs_per_request", p) == pytest.approx(3.0)
    assert "{'pyramid': 1, 'solve': 1, 'upsample': 1}" in capsys.readouterr().err
    spans = program_spans.load(p)
    idle = program_spans.idle_under(p, spans)
    assert idle == pytest.approx({"register": 0.12, "pyramid": 0.08, "derive": 0.05,
                                  "read": 0.10, "recompute": 0.05, "compose": 0.05,
                                  "solve": 0.03, "gc": 0.02, "upsample": 0.10,
                                  "get_motion": 0.01, "warp": 0.09})
    assert spans.lineage(spans.at(0.57)) == ["gc", "solve", "register"]
    assert spans.at(0.61) == 0 and spans.at(1.5) == -1


def test_two_requests_halve_the_per_request_readings(program):
    second = [[n, s + 1.0, d, q + 11 if q >= 0 else q, 2, a] for n, s, d, q, _, a in RECORDS]
    program(RECORDS + second)
    p = made_up()
    p.window, p.solves = (0.0, 2.0), p.solves * 2
    p.device += [[n, s + 1.0, d, k] for n, s, d, k in p.device]
    p.runtime += [[n, s + 1.0, d] for n, s, d in p.runtime]
    assert _read("entry_own_ms", p) == pytest.approx(1e3 * 0.32)
    assert _read("stray_syncs_per_request", p) == pytest.approx(3.0)
    assert _read("loop_idle_pct", p) == pytest.approx(100 * 0.36 / 2.0)


def test_readers_find_nothing_without_the_programs_spans(program, monkeypatch):
    p = made_up()
    monkeypatch.setattr(program_spans, "program_records", lambda: None)
    assert all(_read(n, p) is None for n in NEW)
    # No span inside the window.
    program([[n, s + 5.0, d, q, r, a] for n, s, d, q, r, a in RECORDS])
    assert all(_read(n, p) is None for n in NEW)
    # Records dropped after the last kept one opened, inside the window.
    program(RECORDS, dropped=7)
    assert all(_read(n, p) is None for n in NEW)
    # Dropped only after the window: the window is whole.
    program(RECORDS + [["solve", 1.5, 0.1, -1, 3, None]], dropped=7)
    assert _read("stray_syncs_per_request", p) == pytest.approx(3.0)


def test_readers_on_a_program_without_a_recorder(monkeypatch):
    """The parent commit's ``utils.profiling`` has no ``records``."""
    import opticalflow2d_tpu_torch.utils.profiling as profiling

    monkeypatch.delattr(profiling, "records")
    assert program_spans.program_records() is None
    assert all(_read(n, made_up()) is None for n in NEW)


def test_a_traced_small_cell_reports_the_span_metrics(small_cell):
    """On the CPU the device list is empty, so the whole window is idle:
    the program's spans and what lies outside them add up to it."""
    from torch_bench import run

    captured = []
    original = run.profile_of

    def profile_of(*args, **kw):
        captured.append(original(*args, **kw))
        return captured[-1]

    spec, workload, config, traffic = small_cell("slide_hs_4096.pair")
    run.profile_of = profile_of
    try:
        result = run.run_cell(spec, workload, config, traffic, 2 ** 31 + 99, 0.5, True,
                              torch.device("cpu"))
    finally:
        run.profile_of = original
    assert result["correct"]
    metrics = result["metrics"]
    assert set(NEW) <= set(metrics)
    p = captured[0]
    idle = program_spans.idle_under(p, program_spans.load(p))
    window = p.window[1] - p.window[0]
    assert sum(idle.values()) == pytest.approx(window)
    assert metrics["loop_idle_pct"]["value"] == pytest.approx(
        100 * sum(idle.get(n, 0.0) for n in program_spans.LOOP) / window)
    assert metrics["stray_syncs_per_request"]["value"] == 0.0   # no device to wait on
    assert 0 < metrics["entry_own_ms"]["value"] < 1e3 * window / len(p.solves)
