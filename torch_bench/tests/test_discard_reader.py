"""The reader of the level loop's dropped blocks (``metrics/
discards_per_request.py``) on made-up program spans: one ``discard`` span
a dropped block, counted over the traced requests; 0 for a program that
records spans but drops nothing; nothing for one without the spans. Run by
hand from the repository root: ``python -m pytest torch_bench/tests -q``."""

import pytest

from torch_bench import cells, program_spans
from torch_bench.tests.test_span_readers import RECORDS, made_up


def _with_discards(records, opens):
    """``records`` with a ``discard`` span inside the first ``solve`` at each
    time in ``opens``."""
    solve = next(i for i, r in enumerate(records) if r[0] == "solve")
    return records + [["discard", t, 1e-6, solve, records[solve][4], None] for t in opens]


def _read(p):
    return cells.reader("discards_per_request").read(p)


def test_discards_over_the_traced_requests(monkeypatch):
    records = _with_discards(RECORDS, (0.41, 0.52))
    monkeypatch.setattr(program_spans, "program_records", lambda: (records, 0))
    p = made_up()
    assert _read(p) == pytest.approx(2.0)
    # A second request, one discard more; one that opens after the window
    # does not count.
    second = [[n, s + 1.0, d, q + len(records) if q >= 0 else q, 2, a]
              for n, s, d, q, _, a in _with_discards(RECORDS, (0.45,))]
    late = [["discard", 2.5, 1e-6, -1, 3, None]]
    monkeypatch.setattr(program_spans, "program_records",
                        lambda: (records + second + late, 0))
    p.window, p.solves = (0.0, 2.0), p.solves * 2
    assert _read(p) == pytest.approx(3 / 2)


def test_no_discard_reads_zero_and_no_spans_read_nothing(monkeypatch):
    p = made_up()
    monkeypatch.setattr(program_spans, "program_records", lambda: (RECORDS, 0))
    assert _read(p) == 0.0
    monkeypatch.setattr(program_spans, "program_records", lambda: None)
    assert _read(p) is None
    monkeypatch.setattr(program_spans, "program_records", lambda: (RECORDS, 0))
    p.solves = []
    assert _read(p) is None
