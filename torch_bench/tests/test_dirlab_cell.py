"""The 4DCT cell ``dirlab_fluid.volume``: its data generator (``lung_ct``),
its two readers (``fluid_batch_roofline``, ``fluid_pairs_per_read``) on
made-up profiles whose answers are known, and the cell cut to a size the
CPU runs (``small_cell``): a sound run through the batch entry is correct
with every gap 0, a traced one reads its pairs per read, and the control
and a frozen lockstep step fail. Run by hand from the repository root:
``python -m pytest torch_bench/tests -q``."""

import json

import pytest
import torch

from opticalflow2d_tpu_torch.engine import registration
from torch_bench import cells, correct, program_spans, run, trace
from torch_bench.data import lung_ct
from torch_bench.readings import control_readings
from torch_bench.rooflines import fluid_iter
from torch_bench.tests.test_span_readers import program  # noqa: F401 (a fixture)

WORKLOAD = "dirlab_fluid.volume"
CPU = torch.device("cpu")
SEED = 2 ** 31 + 2222
PEAKS = {"hbm_bytes_per_s": 3.35e12}


def _data():
    config = json.loads((cells.BENCH / "configs" / "dirlab_fluid.json").read_text())
    return config["data"]


@pytest.fixture
def one_thread():
    """One intra-op thread, as tier 1 runs: PyTorch's FFT on several CPU
    threads can round its first call in a process apart from the later
    ones (the splats' blur), so a repeat would not give the same bits. On
    the card the pool comes from cuFFT, which repeats."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_a_sweep_is_every_phase_of_every_slice_against_t00(one_thread):
    data, dims = _data(), (40, 32)
    slices, phases = data["slices"], len(data["phases"])
    pairs = slices * phases
    assert pairs == 640
    a = lung_ct.make_pool(data, dims, 2, SEED, CPU, pairs)
    b = lung_ct.make_pool(data, dims, 2, SEED, CPU, pairs)
    c = lung_ct.make_pool(data, dims, 2, SEED + 1, CPU, pairs)
    for (ra, ma), (rb, mb) in zip(a, b):
        assert ra.shape == ma.shape == (pairs,) + dims and ra.dtype == torch.float32
        assert torch.equal(ra, rb) and torch.equal(ma, mb)
        for x in (ra, ma):
            assert (x.amin(dim=(-2, -1)) == 0).all() and (x.amax(dim=(-2, -1)) == 1).all()
        # T00's slice z stands against the slice z of every phase.
        for k in range(slices, pairs):
            assert torch.equal(ra[k], ra[k % slices])
        # T50 moves further than T10: its slices differ more from T00's.
        gap = (ma - ra).abs().mean(dim=(-2, -1)).view(phases, slices).mean(dim=1)
        assert float(gap[-1]) > float(gap[0])
    assert not torch.equal(a[0][0], c[0][0])
    assert lung_ct.phase_scale(5, 10) == 1.0
    assert 0 < lung_ct.phase_scale(1, 10) < lung_ct.phase_scale(3, 10) < 1.0


def test_the_lungs_grow_towards_the_base_and_vanish_at_the_ends():
    data = _data()
    t = lung_ct.heights(data["slices"], CPU)
    w = lung_ct.lung_profile(t)
    assert float(w[0]) == 0.0 and float(w[-1]) == 0.0
    assert int(w.argmax()) > data["slices"] // 2
    scan = lung_ct.phantom(data, 8, (64, 48), torch.Generator().manual_seed(1), CPU)
    lung = (scan < -500).flatten(1).sum(1)  # air or lung pixels a slice
    assert lung[4] > lung[0]


def _made_up(device, solves, dims=(512, 512), nscales=1):
    return trace.Profile(
        device=device, runtime=[],
        spans=[["bench.request", 0.0, 1.0], ["bench.register", 0.0, 0.9]],
        window=(0.0, 1.0), solves=solves, dims=list(dims), nscales=nscales, block_k=8,
        library_kernels=[], peaks=PEAKS)


BATCH_KERNELS = [
    "void (anonymous namespace)::fluid_iter_batch_kernel<32, 64, 512, 2, 2, true, false>"
    "(float const*, int const*)",
    "void (anonymous namespace)::max_partials_kernel(float const*, float*, int)",
    "void (anonymous namespace)::fluid_metrics_batch_kernel(float const*, int const*)",
    "void (anonymous namespace)::fluid_metrics_reduce_kernel(float const*, float*, int)",
]


def test_fluid_batch_roofline_on_a_made_up_profile():
    device = [[n, 0.01 * i, 0.01, "kernel"] for i, n in enumerate(BATCH_KERNELS)]
    # The single entries, the plain tail and the regrids are not its kernels.
    device += [["void (anonymous namespace)::fluid_metrics_kernel(float const*)", 0.1, 0.3,
                "kernel"],
               ["void at::native::vectorized_elementwise_kernel<4, float>(int)", 0.5, 0.2,
                "kernel"],
               ["void (anonymous namespace)::gather_kernel<2>(float const*)", 0.8, 0.1,
                "kernel"]]
    # Two pairs of one request: each pair's solves, coarse to fine.
    solves = [[[1, 25, 12], [0, 14, 6], [1, 3, 0], [0, 3, 0]]]
    p = _made_up(device, solves)
    least = (28 * 60 * 256 ** 2 + 17 * 60 * 512 ** 2) / 3.35e12
    assert fluid_iter.bytes_per_iteration(512, 512) == 60 * 512 ** 2
    assert cells.reader("fluid_batch_roofline").read(p) == pytest.approx(100 * least / 0.04)
    # Without the pair-axis B7 in the trace (the single-pair loop) it finds nothing.
    p.device = device[1:]
    assert cells.reader("fluid_batch_roofline").read(p) is None


def _reads(opens):
    """Program records: a request whose solve makes a read at each of ``opens``."""
    records = [["register", 0.0, 0.9, -1, 1, None],
               ["solve", 0.05, 0.8, 0, 1, {"scale": 0, "refine": 0, "nx": 512, "ny": 512}]]
    records += [["read", t, 0.001, 1, 1, {"site": "fluid_batch"}] for t in opens]
    return records


def test_fluid_pairs_per_read_on_made_up_spans(program):
    # Three pairs: 4, 2 and 1 iterations, read once an iteration in lockstep.
    solves = [[[0, 4, 1], [0, 2, 0], [0, 1, 0]]]
    program(_reads([0.1, 0.2, 0.3, 0.4]))
    assert cells.reader("fluid_pairs_per_read").read(_made_up([], solves)) == pytest.approx(7 / 4)
    # By map: a read an iteration a pair.
    program(_reads([0.1 * (i + 1) for i in range(7)]))
    assert cells.reader("fluid_pairs_per_read").read(_made_up([], solves)) == pytest.approx(1.0)
    # No read in the window, dropped records, no recorder: nothing.
    program(_reads([]))
    assert cells.reader("fluid_pairs_per_read").read(_made_up([], solves)) is None
    program(_reads([0.1, 0.2]), dropped=2)
    assert cells.reader("fluid_pairs_per_read").read(_made_up([], solves)) is None


def test_fluid_pairs_per_read_without_a_recorder(monkeypatch):
    monkeypatch.setattr(program_spans, "program_records", lambda: None)
    p = _made_up([], [[[0, 4, 1]]])
    assert cells.reader("fluid_pairs_per_read").read(p) is None


def _cell(small_cell):
    """The cut cell: 96 x 80, two levels, three slice pairs a request (the
    first slice of T10, T20 and T30), a pool of 2, both checked."""
    spec, workload, config, traffic = small_cell(WORKLOAD)
    traffic.update(pool=2)
    return spec, workload, config, traffic


def test_sound_4dct_run_is_correct(small_cell, capsys):
    spec, workload, config, traffic = _cell(small_cell)
    r = run.run_cell(spec, workload, config, traffic, SEED, 0.5, False, CPU)
    assert r["correct"] and r["failed"] == 0
    assert list(r["check"]) == ["motion_gap_px", "warp_gap", "iters_gap", "regrids_gap"]
    assert all(c["value"] == 0.0 for c in r["check"].values())
    err = capsys.readouterr().err
    # Both pool requests are checked where the window served both; a
    # loaded host may serve only the first in half a second.
    kept = min(r["attempted"], 2)
    assert f"pairs checked: {3 * kept}, in {kept} request(s) of 3" in err
    assert "SSD reduction" in err


def test_a_traced_small_4dct_run_reads_pairs_per_read(small_cell):
    """On the CPU the trace holds no device operation, so the roofline
    finds nothing, while the program's reads give ``fluid_pairs_per_read``:
    more than one pair a read, the lockstep loop's."""
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
    assert "fluid_batch_roofline" not in result["metrics"]
    p = captured[0]
    reads = program_spans.load(p).count("read", p.window)
    want = trace.iterations(p) / reads
    assert 1.0 < want <= traffic["pairs_per_request"]
    assert result["metrics"]["fluid_pairs_per_read"]["value"] == pytest.approx(want)


def test_4dct_control_fails(small_cell):
    _, _, config, traffic = _cell(small_cell)
    numbers = control_readings(config, traffic, SEED, CPU)
    assert not correct.judge(numbers, config["limits"])


def test_a_frozen_lockstep_fluid_step_fails(small_cell, monkeypatch):
    """The lockstep step writes each listed pair's motion and velocity back
    unchanged."""
    def frozen(*args, **kw):
        def step(u, velocity, g, pairs, vel_out, u_out, scratch):
            for p in pairs:
                vel_out[p], u_out[p] = velocity[p], u[p]
        return step

    monkeypatch.setattr(registration, "make_fluid_batch_step", frozen)
    spec, workload, config, traffic = _cell(small_cell)
    assert not run.run_cell(spec, workload, config, traffic, SEED, 0.5, False, CPU)["correct"]
