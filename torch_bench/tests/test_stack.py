"""Requests of many pairs: the pool and the answers of a stacked cell,
``pairs_per_s`` counted in pairs, the check over every pair of a stack,
and the reader of ``pairs_per_read``."""

import pytest
import torch

from torch_bench import cells, correct, program_spans, run, trace
from torch_bench.data import cell_sequence

CPU = torch.device("cpu")
SEED = 2 ** 31 + 1234


def _stack(small_cell):
    """The small series cell's config and traffic, its pool, and the
    plain reference's answer to its first entry, stacked as the batch
    entry answers."""
    _, _, config, traffic = small_cell("timelapse_hs_1024.series")
    pool = cells.make_pool(config, traffic, SEED, CPU)
    pairs = traffic["pairs_per_request"]
    answers = [correct.reference_answer(config, iref, imov)
               for iref, imov in correct.split(pool[0], pairs)]
    stacked = (torch.stack([a[0] for a in answers]), torch.stack([a[1] for a in answers]),
               [s for a in answers for s in a[2]])
    return config, pairs, pool, stacked


def _window(answer):
    w = run.Window()
    w.kept, w.attempted, w.seconds = {0: answer}, 1, 1.0
    return w


def test_series_are_chains_of_frames(small_cell):
    _, _, config, traffic = small_cell("timelapse_hs_1024.series")
    dims, pairs = tuple(config["dims"]), traffic["pairs_per_request"]
    a = cell_sequence.make_pool(config["data"], dims, 2, SEED, CPU, pairs)
    b = cell_sequence.make_pool(config["data"], dims, 2, SEED, CPU, pairs)
    c = cell_sequence.make_pool(config["data"], dims, 2, SEED + 1, CPU, pairs)
    for (ra, ma), (rb, mb) in zip(a, b):
        assert ra.shape == (pairs,) + dims and ra.dtype == torch.float32
        assert torch.equal(ra, rb) and torch.equal(ma, mb)
        assert torch.equal(ra[1:], ma[:-1])      # pair t + 1 starts at pair t's moving frame
        assert float(ra[0].min()) == 0.0 and float(ra[0].max()) == 1.0
        assert all(not torch.equal(ra[t], ma[t]) for t in range(pairs))
    assert not torch.equal(a[0][0], c[0][0])


def test_a_stack_equal_to_the_reference_is_correct(small_cell, capsys):
    config, pairs, pool, stacked = _stack(small_cell)
    ok, numbers = run.check(config, pairs, pool, _window(stacked))
    assert ok and all(numbers[n]["value"] == 0.0 for n in numbers)
    err = capsys.readouterr().err
    assert f"pairs checked: {pairs}, in 1 request(s) of {pairs}" in err
    assert all(f"pair 0.{i}: " in err for i in range(pairs)) and "SSD reduction" in err


@pytest.mark.parametrize("fault", ("motion", "warp", "iterations"))
def test_a_fault_in_one_pair_of_a_stack_is_not_correct(small_cell, fault):
    config, pairs, pool, (motion, warped, solves) = _stack(small_cell)
    last = pairs - 1
    if fault == "motion":
        motion = motion.clone()
        motion[last, 0, 40, 30] += 1e-3
    elif fault == "warp":
        warped = warped.clone()
        warped[last, 40, 30] += 1e-3
    else:
        per = len(solves) // pairs
        scale, its, regrids = solves[last * per + 1]
        solves = list(solves)
        solves[last * per + 1] = (scale, its + 1, regrids)
    ok, numbers = run.check(config, pairs, pool, _window((motion, warped, solves)))
    assert not ok
    name = {"motion": "motion_gap_px", "warp": "warp_gap", "iterations": "iters_gap"}[fault]
    assert numbers[name]["value"] > numbers[name]["limit"]


def test_one_pair_a_request_is_split_into_itself():
    entry = (torch.zeros(4, 3), torch.ones(4, 3))
    assert correct.split(entry, 1)[0] is entry
    stacked = (torch.arange(24.0).view(2, 4, 3), torch.zeros(2, 3), [(1, 5, 0), (0, 6, 0),
                                                                     (1, 7, 0), (0, 8, 0)])
    (m0, w0, s0), (m1, w1, s1) = correct.split(stacked, 2)
    assert torch.equal(m1, stacked[0][1]) and s0 == [(1, 5, 0), (0, 6, 0)]
    assert s1 == [(1, 7, 0), (0, 8, 0)]


def test_pairs_per_s_counts_pairs():
    w = run.Window()
    w.attempted, w.failed, w.seconds, w.latencies = 7, 1, 4.0, [0.5] * 6 + [float("inf")]
    values = run.end_to_end(w, 16, 3 * 2 ** 30, 9.5)
    assert values["pairs_per_s"] == (7 - 1) * 16 / 4.0
    assert values["latency_p90_s"] == float("inf")       # a request, not a pair
    assert values["peak_mem_gib"] == 3.0 and values["setup_s"] == 9.5
    assert run.end_to_end(w, 1, 0, 0.0)["pairs_per_s"] == 6 / 4.0


def test_a_mismatched_stack_is_refused(small_cell, monkeypatch):
    _, _, config, traffic = small_cell("timelapse_hs_1024.series")
    dims, pairs = config["dims"], traffic["pairs_per_request"]
    real = cell_sequence.make_pool

    def short(*args):
        return [(iref[1:], imov[1:]) for iref, imov in real(*args)]

    monkeypatch.setattr(cell_sequence, "make_pool", short)
    with pytest.raises(ValueError, match="pool entry 0"):
        cells.make_pool(config, traffic, SEED, CPU)
    motion, warped = torch.zeros([pairs, 2] + dims), torch.zeros([pairs] + dims)
    solves = [(0, 1, 0)] * pairs
    correct.check_answer((motion, warped, solves), pairs, dims)
    for bad in ((motion[1:], warped, solves), (motion, warped[:, None], solves),
                (motion, warped, solves[1:]), (motion[0], warped[0], solves[:1])):
        with pytest.raises(ValueError, match="an answer of"):
            correct.check_answer(bad, pairs, dims)


def test_a_refused_answer_counts_as_failed():
    class Client:
        def request(self, iref, imov):
            return torch.zeros(3, 2, 4, 4), torch.zeros(2, 4, 4), [(0, 1, 0)] * 3

    pool = [(torch.zeros(3, 4, 4), torch.zeros(3, 4, 4))]
    w = run.serve(Client(), pool, 0.0, {0}, lambda: None, None, 0.0, 3, [4, 4])
    assert w.attempted == 1 and w.failed == 1 and not w.kept


# One traced request of three pairs, three solves each (block_k 8): pair
# 0 takes 16, 3 and 8 iterations, pair 1 takes 9, 24 and 1, pair 2 takes
# 0, 8 and 17. Blocks a pair took part in: 2 + 1 + 1, 2 + 3 + 1, 0 + 1 + 3,
# 14 in all; reads a solve: 2, 3, 3.
SOLVES = [[[2, 16, 0], [1, 3, 0], [0, 8, 0], [2, 9, 0], [1, 24, 0], [0, 1, 0],
           [2, 0, 0], [1, 8, 0], [0, 17, 0]]]


def _reads_at(times, window=(0.0, 1.0)):
    records = [["register", 0.0, 0.9, -1, 1, None]]
    records += [["read", t, 0.001, 0, 1, {"site": "batch"}] for t in times]
    p = trace.Profile(device=[], runtime=[], spans=[], window=window, solves=SOLVES,
                      dims=[64, 64], nscales=2, block_k=8, library_kernels=[], peaks={})
    return records, p


def test_pairs_per_read_on_a_made_up_profile(monkeypatch):
    records, p = _reads_at([0.1 * (i + 1) for i in range(8)] + [1.5])  # the last after it
    monkeypatch.setattr(program_spans, "program_records", lambda: (records, 0))
    assert cells.reader("pairs_per_read").read(p) == pytest.approx(14 / 8)
    records, p = _reads_at([])
    monkeypatch.setattr(program_spans, "program_records", lambda: (records, 0))
    assert cells.reader("pairs_per_read").read(p) is None
    monkeypatch.setattr(program_spans, "program_records", lambda: None)
    assert cells.reader("pairs_per_read").read(p) is None
