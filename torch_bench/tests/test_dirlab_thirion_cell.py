"""The 4DCT Thirion demons cell ``dirlab_thirion.volume``: its two readers
(``demons_batch_roofline``, ``demons_pairs_per_read``) on made-up profiles
whose answers are known, and the cell cut to a size the CPU runs
(``small_cell``): a sound run through the batch entry is correct with
every gap 0, a traced one reads its pairs per read, and the control and
two planted faults of the lockstep step fail. Run by hand from the
repository root: ``python -m pytest torch_bench/tests -q``."""

import pytest
import torch

from opticalflow2d_tpu_torch.engine import registration
from torch_bench import cells, correct, program_spans, run, trace
from torch_bench.readings import control_readings
from torch_bench.rooflines import demons_onepass
from torch_bench.tests.test_span_readers import program  # noqa: F401 (a fixture)

THIRION_WORKLOAD = "dirlab_thirion.volume"
THIRION_CPU = torch.device("cpu")
THIRION_SEED = 2 ** 31 + 2424
THIRION_PEAKS = {"hbm_bytes_per_s": 3.35e12}


def _thirion_profile(device, solves, dims=(512, 512), nscales=1):
    return trace.Profile(
        device=device, runtime=[],
        spans=[["bench.request", 0.0, 1.0], ["bench.register", 0.0, 0.9]],
        window=(0.0, 1.0), solves=solves, dims=list(dims), nscales=nscales, block_k=8,
        library_kernels=[], peaks=THIRION_PEAKS)


def test_demons_batch_roofline_on_a_made_up_profile():
    device = [
        ["void (anonymous namespace)::demons_onepass_batch_kernel<5, 64, 64, 2, false>"
         "(float const*, float const*, float const*, float*, float*, Rows, int, int, Taps, "
         "Taps, float, float, int const*, int)", 0.0, 0.03, "kernel"],
        ["void (anonymous namespace)::sum_partials_kernel(float const*, float*, int, int)",
         0.05, 0.01, "kernel"],
        # The single B10, the batched warp and compose, a plain op: not its kernels.
        ["void (anonymous namespace)::demons_onepass_kernel<5, 64, 64, 2, false, false>"
         "(float const*)", 0.1, 0.3, "kernel"],
        ["void (anonymous namespace)::gather_kernel<2>(float const*)", 0.5, 0.1, "kernel"],
        ["void at::native::vectorized_elementwise_kernel<4, float>(int)", 0.7, 0.2, "kernel"],
    ]
    # Two pairs of one request: each pair's solves, coarse to fine.
    solves = [[[1, 25, 0], [0, 25, 0], [1, 25, 0], [0, 7, 0]]]
    p = _thirion_profile(device, solves)
    least = 24 * (50 * 256 ** 2 + 32 * 512 ** 2) / 3.35e12
    assert demons_onepass.bytes_moved(solves[0], [512, 512], 1) == 24 * (
        50 * 256 ** 2 + 32 * 512 ** 2)
    assert cells.reader("demons_batch_roofline").read(p) == pytest.approx(100 * least / 0.04)
    # Without the pair-axis B10 in the trace (a map, or the parent) it finds nothing.
    p.device = device[1:]
    assert cells.reader("demons_batch_roofline").read(p) is None


def _thirion_reads(opens, site="demons_batch"):
    """Program records: a request whose solve makes a read at each of ``opens``."""
    records = [["register", 0.0, 0.9, -1, 1, None],
               ["solve", 0.05, 0.8, 0, 1, {"scale": 0, "refine": 0, "nx": 512, "ny": 512}]]
    records += [["read", t, 0.001, 1, 1, {"site": site, "pairs": 3}] for t in opens]
    return records


def test_demons_pairs_per_read_on_made_up_spans(program):
    # Three pairs: 4, 2 and 1 iterations, read once an iteration in lockstep.
    solves = [[[0, 4, 0], [0, 2, 0], [0, 1, 0]]]
    reader = cells.reader("demons_pairs_per_read")
    program(_thirion_reads([0.1, 0.2, 0.3, 0.4]))
    assert reader.read(_thirion_profile([], solves)) == pytest.approx(7 / 4)
    # Reads of another site (the one-pair demons loop of a map, the fluid
    # loop) and reads outside the window are not its reads.
    program(_thirion_reads([0.1, 0.2, 0.3, 0.4, 1.5])
            + _thirion_reads([0.15, 0.25], site="demons")[2:]
            + _thirion_reads([0.35], site="fluid_batch")[2:])
    assert reader.read(_thirion_profile([], solves)) == pytest.approx(7 / 4)
    # By map: no read of its site; none in the window; dropped records.
    program(_thirion_reads([0.1 * (i + 1) for i in range(7)], site="demons"))
    assert reader.read(_thirion_profile([], solves)) is None
    program(_thirion_reads([]))
    assert reader.read(_thirion_profile([], solves)) is None
    program(_thirion_reads([0.1, 0.2]), dropped=2)
    assert reader.read(_thirion_profile([], solves)) is None


def test_demons_pairs_per_read_without_a_recorder(monkeypatch):
    monkeypatch.setattr(program_spans, "program_records", lambda: None)
    p = _thirion_profile([], [[[0, 4, 0]]])
    assert cells.reader("demons_pairs_per_read").read(p) is None


def _thirion_cell(small_cell):
    """The cut cell: 96 x 80, two levels, three slice pairs a request (the
    first slice of T10, T20 and T30), a pool of 2, both checked."""
    spec, workload, config, traffic = small_cell(THIRION_WORKLOAD)
    traffic.update(pool=2)
    return spec, workload, config, traffic


def test_sound_thirion_4dct_run_is_correct(small_cell, capsys):
    spec, workload, config, traffic = _thirion_cell(small_cell)
    r = run.run_cell(spec, workload, config, traffic, THIRION_SEED, 0.5, False, THIRION_CPU)
    assert r["correct"] and r["failed"] == 0
    assert list(r["check"]) == ["motion_gap_px", "warp_gap", "iters_gap", "regrids_gap"]
    assert all(c["value"] == 0.0 for c in r["check"].values())
    err = capsys.readouterr().err
    kept = min(r["attempted"], 2)
    assert f"pairs checked: {3 * kept}, in {kept} request(s) of 3" in err
    assert "SSD reduction" in err


def test_a_traced_small_thirion_run_reads_pairs_per_read(small_cell):
    """On the CPU the trace holds no device operation, so the roofline
    finds nothing, while the program's reads give ``demons_pairs_per_read``:
    every pair of the stack at each read while none has stopped."""
    captured = []
    original = run.profile_of

    def profile_of(*args, **kw):
        captured.append(original(*args, **kw))
        return captured[-1]

    spec, workload, config, traffic = _thirion_cell(small_cell)
    run.profile_of = profile_of
    try:
        result = run.run_cell(spec, workload, config, traffic, THIRION_SEED, 1.0, True,
                              THIRION_CPU)
    finally:
        run.profile_of = original
    assert result["correct"]
    assert "demons_batch_roofline" not in result["metrics"]
    p = captured[0]
    records, _ = program_spans.program_records()
    reads = [r for r in records if r[0] == "read" and p.window[0] <= r[1] <= p.window[1]]
    assert reads and all(r[5]["site"] == "demons_batch" for r in reads)
    want = trace.iterations(p) / len(reads)
    assert 1.0 < want <= traffic["pairs_per_request"]
    assert result["metrics"]["demons_pairs_per_read"]["value"] == pytest.approx(want)


def test_thirion_4dct_control_fails(small_cell):
    _, _, config, traffic = _thirion_cell(small_cell)
    numbers = control_readings(config, traffic, THIRION_SEED, THIRION_CPU)
    assert not correct.judge(numbers, config["limits"])


def _no_diffusion_smoothing(original):
    """The lockstep step with sigma_diffusion so small that its Gaussian
    is the identity: the step skips the smoothing of the motion."""
    def make(si, sx, sd, sf, kw, *args, **kwargs):
        return original(si, sx, 1e-3, sf, kw, *args, **kwargs)
    return make


def _nudged(original):
    """The lockstep step whose every new estimate moves by 1e-3 px."""
    def make(*args, **kwargs):
        step = original(*args, **kwargs)

        def nudged(u, irefs, iaux, pairs, out):
            sums = step(u, irefs, iaux, pairs, out)
            for p in pairs:
                out[p] += 1e-3
            return sums
        return nudged
    return make


@pytest.mark.parametrize("fault", [_no_diffusion_smoothing, _nudged])
def test_a_faulty_lockstep_thirion_step_fails(small_cell, monkeypatch, fault):
    monkeypatch.setattr(registration, "make_demons_batch_step",
                        fault(registration.make_demons_batch_step))
    spec, workload, config, traffic = _thirion_cell(small_cell)
    r = run.run_cell(spec, workload, config, traffic, THIRION_SEED, 0.5, False, THIRION_CPU)
    assert not r["correct"]
    assert r["check"]["motion_gap_px"]["value"] > config["limits"]["motion_gap_px"]
