"""The fluid cell's readers on made-up profiles whose answers are known:
``fluid_iter_roofline``'s least bytes on hand-made solves (a 16384² level
on the two-pass route, an 8192² level on the one-pass route) and
``regrid_ms`` on made-up span records, including where it must find
nothing. Run by hand from the repository root: ``python -m pytest
torch_bench/tests -q``."""

import pytest

from torch_bench import cells, program_spans, trace
from torch_bench.rooflines import fluid_iter
from torch_bench.tests.test_span_readers import program  # noqa: F401 (a fixture)

PEAKS = {"hbm_bytes_per_s": 3.35e12}
KERNEL_NAMES = [
    "void (anonymous namespace)::fluid_metrics_kernel(float const*, float const*, float*)",
    "void (anonymous namespace)::sum_partials_kernel(float const*, float*, int, int)",
    "void (anonymous namespace)::min_partials_kernel(float const*, float*, int)",
    "void (anonymous namespace)::fluid_iter_kernel<512, 2, false>(float const*, int)",
    "void (anonymous namespace)::max_partials_kernel(float const*, float*, int)",
    "void (anonymous namespace)::fluid_euler_kernel(float const*, float const*, float*)",
]


def _read(name, p):
    return cells.reader(name).read(p)


def made_up(solves, device, dims=(16384, 16384), nscales=1):
    return trace.Profile(
        device=device, runtime=[],
        spans=[["bench.request", 0.0, 1.0], ["bench.register", 0.0, 0.9]],
        window=(0.0, 1.0), solves=solves, dims=list(dims), nscales=nscales, block_k=8,
        library_kernels=[], peaks=PEAKS)


def test_least_bytes_by_route():
    # 16384^2 past 8192: B5 16 + B8 36 + B9 24 B/px an iteration.
    assert fluid_iter.bytes_per_iteration(16384, 16384) == 76 * 16384 * 16384
    # 8192^2 is not past 8192: B5 16 + B7 44.
    assert fluid_iter.bytes_per_iteration(8192, 8192) == 60 * 8192 * 8192
    assert fluid_iter.bytes_per_iteration(8224, 32) == 76 * 8224 * 32
    solves = [(1, 25, 3), (0, 25, 7)]   # scale 1 is 8192^2, scale 0 16384^2
    want = 25 * 60 * 8192 ** 2 + 25 * 76 * 16384 ** 2
    assert fluid_iter.bytes_moved(solves, (16384, 16384), 1) == want
    # Regrids add no launch of these kernels; a request's iterations do.
    assert fluid_iter.bytes_moved([(1, 25, 0), (0, 25, 0)], (16384, 16384), 1) == want


def test_fluid_iter_roofline_on_a_made_up_profile():
    device = [[n, 0.01 * i, 0.01, "kernel"] for i, n in enumerate(KERNEL_NAMES)]
    device += [["void at::native::vectorized_elementwise_kernel<4, float>(int)", 0.5, 0.2,
                "kernel"],
               ["void (anonymous namespace)::gather_kernel<2>(float const*)", 0.8, 0.1,
                "kernel"]]
    solves = [[[1, 25, 3], [0, 25, 7]], [[1, 20, 0], [0, 25, 2]]]
    p = made_up(solves, device)
    least = (45 * 60 * 8192 ** 2 + 50 * 76 * 16384 ** 2) / 3.35e12
    assert _read("fluid_iter_roofline", p) == pytest.approx(100 * least / 0.06)
    # Without the fluid kernels in the trace it finds nothing.
    p.device = device[len(KERNEL_NAMES):]
    assert _read("fluid_iter_roofline", p) is None


# [name, start_s, dur_s, parent, request, attrs]: one request with two
# regrids on its finer level. Window 0 .. 1.
RECORDS = [
    ["register", 0.00, 0.90, -1, 1, None],                                       # 0
    ["solve", 0.10, 0.30, 0, 1, {"scale": 1, "refine": 0, "nx": 8192, "ny": 8192}],   # 1
    ["solve", 0.40, 0.45, 0, 1, {"scale": 0, "refine": 0, "nx": 16384, "ny": 16384}],  # 2
    ["regrid", 0.50, 0.02, 2, 1, {"scale": 0, "nx": 16384, "ny": 16384}],        # 3
    ["compose", 0.50, 0.005, 3, 1, None],                                        # 4
    ["derive", 0.505, 0.015, 3, 1, None],                                        # 5
    ["regrid", 0.70, 0.03, 2, 1, {"scale": 0, "nx": 16384, "ny": 16384}],        # 6
    ["compose", 0.70, 0.01, 6, 1, None],                                         # 7
    ["derive", 0.71, 0.02, 6, 1, None],                                          # 8
]


def test_regrid_ms_on_made_up_spans(program):
    program(RECORDS)
    p = made_up([[[1, 25, 0], [0, 25, 2]]], [])
    assert _read("regrid_ms", p) == pytest.approx(1e3 * (0.02 + 0.03))
    # Two requests, the second without a regrid: the mean over both.
    second = [[n, s + 1.0, d, q + 9 if q >= 0 else q, 2, a] for n, s, d, q, _, a in RECORDS
              if n not in ("regrid", "compose", "derive")]
    program(RECORDS + second)
    p = made_up([[[1, 25, 0], [0, 25, 2]], [[1, 25, 0], [0, 25, 0]]], [])
    p.window = (0.0, 2.0)
    assert _read("regrid_ms", p) == pytest.approx(1e3 * 0.05 / 2)
    # No regrid in the window and none reported: zero.
    program([r for r in RECORDS if r[0] not in ("regrid", "compose", "derive")])
    p = made_up([[[1, 25, 0], [0, 25, 0]]], [])
    assert _read("regrid_ms", p) == 0.0


def test_regrid_ms_finds_nothing_without_the_span(program, monkeypatch):
    p = made_up([[[1, 25, 0], [0, 25, 2]]], [])
    # The solves report regrids the program recorded no span for: a
    # program without the regrid span.
    program([r for r in RECORDS if r[0] != "regrid"])
    assert _read("regrid_ms", p) is None
    # Records dropped inside the window.
    program(RECORDS, dropped=3)
    assert _read("regrid_ms", p) is None
    # No recorder at all.
    monkeypatch.setattr(program_spans, "program_records", lambda: None)
    assert _read("regrid_ms", p) is None


def test_regrid_ms_on_a_program_without_a_recorder(monkeypatch):
    import opticalflow2d_tpu_torch.utils.profiling as profiling

    monkeypatch.delattr(profiling, "records")
    assert _read("regrid_ms", made_up([[[0, 25, 2]]], [], nscales=0)) is None
