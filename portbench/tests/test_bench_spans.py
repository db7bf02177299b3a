"""The readers of the program's spans (`progspans.py` and the metrics that
read it) on synthetic span records and a synthetic device trace, and one
traced run of the tiny cell on the CPU that reads them from the program."""

import os
import sys
import time
import types

import pytest
import torch

from eventclip_tpu_torch.utils.spans import Span
from portbench import core, devtrace, progspans, run
from portbench.tests.tiny import BENCH_DIR, tiny_cell

BASE = 1_700_000_000 * 10 ** 9  # an epoch time in ns, as the program stamps
MS = 10 ** 6

SUMS = {
    "seed_ms.batch": ["serve.seed"],
    "stream_prep_ms.batch": ["serve.canonical", "serve.centre",
                             "serve.window"],
    "stack_pack_ms.batch": ["serve.stack", "serve.pack"],
    "h2d_ms.batch": ["serve.place"],
    "enqueue_ms.batch": ["serve.enqueue"],
    "fetch_wait_ms.batch": ["serve.fetch"],
}
NEW = list(SUMS) + ["pad_share.batch", "idle_outside_spans_ms.batch"]


def metric(name):
    return core.load_file(os.path.join(BENCH_DIR, "metrics", name + ".py"),
                          "metric_" + name)


class Tree:
    """Builds span records: `add(name, start ms, end ms, parent)`."""

    def __init__(self):
        self.recs = []

    def add(self, name, a, b, parent=None, **counts):
        sid = len(self.recs) + 1
        root = sid if parent is None else parent.root
        r = Span(name, BASE + int(a * MS), BASE + int(b * MS), sid,
                 None if parent is None else parent.id, root, counts)
        self.recs.append(r)
        return r


def two_requests():
    """Two requests of two streams each; every stage a fixed length (ms)."""
    t = Tree()
    for k in range(2):
        at = 1000.0 * k
        g = t.add("serve.gather_windows", at, at + 200)
        for s in range(2):
            o = at + 80 * s
            t.add("serve.canonical", o, o + 10, g)
            t.add("serve.seed", o + 10, o + 30, g)
            t.add("serve.centre", o + 30, o + 45, g)
            t.add("serve.window", o + 45, o + 53, g)
        t.add("serve.stack", at + 170, at + 190, g)
        p = t.add("serve.predict_windows", at + 200, at + 700)
        t.add("serve.pack", at + 200, at + 230, p, valid_views=250,
              packed_views=320)
        t.add("serve.place", at + 230, at + 235, p)
        t.add("serve.enqueue", at + 235, at + 245, p)
        t.add("serve.fetch", at + 245, at + 690, p)
    return t.recs


WANT = {  # ms a request
    "seed_ms.batch": 2 * 20.0,
    "stream_prep_ms.batch": 2 * (10 + 15 + 8.0),
    "stack_pack_ms.batch": 20.0 + 30.0,
    "h2d_ms.batch": 5.0,
    "enqueue_ms.batch": 10.0,
    "fetch_wait_ms.batch": 445.0,
}


@pytest.fixture
def recorded(monkeypatch):
    """Make the readers see `holder[0]` as the program's spans."""
    holder = [[]]
    monkeypatch.setattr(progspans, "recorded", lambda: holder[0])
    return holder


def ctx_of(requests=2, trace=None):
    return types.SimpleNamespace(requests=[{"valid_views": 250}] * requests,
                                 trace=trace, spans={}, window_s=2.0)


@pytest.mark.parametrize("name", list(SUMS))
def test_stage_sums_are_ms_a_request(recorded, name):
    recorded[0] = two_requests()
    assert metric(name).read(ctx_of()) == pytest.approx(WANT[name],
                                                        abs=1e-6)
    assert metric(name).read(ctx_of(requests=4)) == pytest.approx(
        WANT[name] / 2, abs=1e-6)


def test_pad_share_is_padding_over_packed_slots(recorded):
    t = Tree()
    t.add("serve.pack", 0, 1, valid_views=250, packed_views=320)
    t.add("serve.pack", 2, 3, valid_views=255, packed_views=320)
    t.add("serve.window", 4, 5, valid_views=9)  # not a packing count
    recorded[0] = t.recs
    assert metric("pad_share.batch").read(ctx_of()) == pytest.approx(
        100 * (1 - 505 / 640))


@pytest.mark.parametrize("name", NEW)
def test_nothing_recorded_reads_none(recorded, name):
    trace = devtrace.Trace([("k", 1.0, 1.0)], [], (0.0, 5.0))
    assert metric(name).read(ctx_of(trace=trace)) is None
    recorded[0] = two_requests()
    assert metric(name).read(ctx_of(requests=0, trace=trace)) is None


def test_a_program_without_the_recorder_reads_none(monkeypatch):
    import eventclip_tpu_torch.utils as utils

    monkeypatch.setitem(sys.modules, "eventclip_tpu_torch.utils.spans", None)
    monkeypatch.delattr(utils, "spans", raising=False)
    assert progspans.recorded() == []
    for name in NEW:
        assert metric(name).read(ctx_of(trace=devtrace.Trace(
            [], [], (0.0, 1.0)))) is None


def test_idle_within_any_stretch():
    idle = progspans.Idle([(1.0, 2.0), (3.0, 5.0)])
    assert idle.total == 3.0
    assert idle.within(1.5, 4.0) == pytest.approx(1.5)
    assert idle.within(0.0, 10.0) == pytest.approx(3.0)
    assert idle.within(2.0, 3.0) == 0.0
    assert idle.within(4.0, 3.0) == 0.0
    assert progspans.Idle([]).within(0.0, 1.0) == 0.0
    assert progspans.idle_outside([(3.5, 4.5), (0.5, 1.2), (1.1, 1.4)],
                                  idle, 0.0, 5.0) == pytest.approx(1.6)


def test_idle_is_put_down_to_the_innermost_span(recorded, capsys):
    """One root [0.5, 3.0] s with `serve.seed` [0.5, 1.5] and
    `serve.fetch` [2.0, 3.0]; the card busy [1.2, 2.5] of the window
    [0, 5]. Idle [0, 1.2] and [2.5, 5]: under the root 0.7 (in the seed)
    + 0.5 (in the fetch), under no span 2.5; two requests."""
    t = Tree()
    root = t.add("serve.predict", 500, 3000)
    t.add("serve.seed", 500, 1500, root)
    t.add("serve.fetch", 2000, 3000, root)
    recorded[0] = t.recs
    lo = BASE * 1e-9
    trace = devtrace.Trace([("k", lo + 1.2, 1.3)], [], (lo, lo + 5.0))
    got = metric("idle_outside_spans_ms.batch").read(ctx_of(trace=trace))
    assert got == pytest.approx(2500 / 2, abs=1e-3)
    line = capsys.readouterr().err.strip().splitlines()[-1]
    assert "by program span: serve.seed 350.000, serve.fetch 250.000; " \
        "under no span 1250.000; idle in all 1850.000" in line
    assert "serve.predict" not in line  # its own time holds no idle
    by = progspans.idle_by_stage(t.recs, progspans.Idle(trace.idle))
    assert by == {"serve.seed": pytest.approx(0.7, abs=1e-6),
                  "serve.fetch": pytest.approx(0.5, abs=1e-6)}


def test_roots_count_once_where_threads_overlap(recorded):
    """Two roots that overlap in time (two handler threads) cover their
    union once; the idle time under both is not counted twice."""
    t = Tree()
    t.add("serve.gather_windows", 0, 2000)
    t.add("serve.gather_windows", 1000, 3000)
    recorded[0] = t.recs
    lo = BASE * 1e-9
    trace = devtrace.Trace([("k", lo + 3.5, 0.5)], [], (lo, lo + 4.0))
    assert metric("idle_outside_spans_ms.batch").read(
        ctx_of(requests=1, trace=trace)) == pytest.approx(500.0, abs=1e-3)


def test_a_full_ring_reads_none(monkeypatch):
    """A ring that has reached its bound may have dropped the window's
    oldest spans: the readers give None rather than a short sum."""
    import collections

    from eventclip_tpu_torch.utils import spans

    monkeypatch.setattr(spans, "CAPACITY", 4)
    monkeypatch.setattr(spans, "_ring", collections.deque(maxlen=4))
    spans.enable()
    try:
        for _ in range(3):
            with spans.span("serve.seed"):
                pass
        assert len(progspans.recorded()) == 3
        assert metric("seed_ms.batch").read(ctx_of()) is not None
        for _ in range(2):
            with spans.span("serve.seed"):
                pass
    finally:
        spans.disable()
    assert len(spans.records()) == 4
    assert progspans.recorded() == []
    for name in NEW:
        assert metric(name).read(ctx_of(trace=devtrace.Trace(
            [], [], (0.0, 1.0)))) is None


def test_a_traced_cpu_run_reads_the_programs_spans():
    """The tiny cell traced on the CPU (a profiler session without the
    card): every stage reader finds the program's spans; the idle reader
    has no device trace to read."""
    cell = tiny_cell()
    res = run.run(cell, 5, 0.3, True, torch.device("cpu"), time.time(),
                  log=lambda m: None)
    assert res["correct"]
    got = res["metrics"]
    for name in SUMS:
        assert got[name]["value"] > 0, name
    assert 0 <= got["pad_share.batch"]["value"] < 100
    assert "idle_outside_spans_ms.batch" not in got
