"""The serving host half on its pool of worker threads
(`serve.Predictor.gather_windows`): windows and masks bit-identical to
the serial computation (`test_torch_spans._parent_recipe`: one stream at
a time, hashed, centred, packed and stacked) however many workers run,
the lowest bad stream named, the pool's size, the content seed without a
copy, the span tree of a pooled request, and the sweep script that reads
`serve.WORKER_EVENTS`."""

import importlib.util
import os
import sys
import threading
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from eventclip_tpu_torch import serve
from eventclip_tpu_torch.data.host_ops import (gather_event_windows,
                                               prepare_stream, tta_variants)
from eventclip_tpu_torch.serve import Predictor
from eventclip_tpu_torch.utils import spans
from tests.test_torch_spans import NAMES, _parent_recipe, _streams, _TinyZS

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def pred():
    return Predictor(_TinyZS(), NAMES, smoke=True, batch_size=4,
                     device="cpu")


@pytest.fixture(scope="module")
def pred_tta():
    return Predictor(_TinyZS(), NAMES, smoke=True, batch_size=4,
                     device="cpu", tta=True)


@pytest.fixture
def pooled(monkeypatch):
    """Every request of two or more streams on the pool, eight cores or
    not."""
    monkeypatch.setattr(serve, "WORKER_EVENTS", 1)
    monkeypatch.setattr(os, "sched_getaffinity", lambda pid: set(range(8)))


@pytest.fixture
def windowing_threads(monkeypatch):
    """The thread of every stream's windowing, in call order."""
    seen = []
    orig = serve.gather_event_windows

    def where(*a, **kw):
        seen.append(threading.get_ident())
        return orig(*a, **kw)

    monkeypatch.setattr(serve, "gather_event_windows", where)
    return seen


@pytest.fixture(autouse=True)
def fresh_store():
    spans.disable()
    spans.clear()
    yield
    spans.disable()
    spans.clear()


def _gather(p, streams):
    """gather_windows with spans on -> (wins, valids, the root's counts)."""
    spans.enable()
    try:
        out = p.gather_windows(streams)
    finally:
        spans.disable()
    root = [r for r in spans.records() if r.name == "serve.gather_windows"]
    assert len(root) == 1
    spans.clear()
    return out + (root[0].counts,)


def _serial_tta(p, streams):
    """The TTA host half one stream at a time: the four variants' windows
    drawn from one content-seeded rng in turn, variant rows consecutive."""
    wins, masks = [], []
    for e in streams:
        e = np.array(e, dtype=np.float32, copy=True)
        if e[:, 3].min() >= -0.5:
            e[:, 3] = np.where(e[:, 3] <= 0.5, -1.0, 1.0)
        rng = np.random.default_rng(zlib.crc32(
            np.ascontiguousarray(e).tobytes()))
        for v in tta_variants(prepare_stream(e, p.resolution),
                              p.resolution):
            w, m = gather_event_windows(v, p.window, p.views, rng=rng,
                                        packed=True)
            wins.append(w)
            masks.append(m)
    return np.stack(wins), np.stack(masks)


# lengths for a window of 1000 events and 10 views: one window, ten
# windows, and more windows than views (the seeded permutation)
CASES = {
    "float64": dict(lengths=(2600, 900, 14700), cast=np.float64),
    "fortran": dict(lengths=(2600, 900, 14700), order="F"),
    "polarity_01": dict(lengths=(4100, 1200, 9000), polarity01=True),
    "more_windows_than_views": dict(lengths=(13700, 25000, 41000)),
    "single_and_ten_windows": dict(lengths=(800, 10000, 600, 10400)),
    "tta": dict(lengths=(2600, 900, 14700), tta=True),
}


def _some(seed, lengths):
    """`_streams` of any count (it makes the fifth a 0/1-polarity dump)."""
    lengths = list(lengths)
    return _streams(seed, lengths + [1000] * (5 - len(lengths)))[
        :len(lengths)]


def _case_streams(case, n, seed):
    spec = CASES[case]
    out = _some(seed, [spec["lengths"][i % len(spec["lengths"])]
                       for i in range(n)])
    if spec.get("polarity01"):
        for e in out:
            e[:, 3] = e[:, 3] > 0
    if "cast" in spec:
        out = [e.astype(spec["cast"]) for e in out]
    if spec.get("order") == "F":
        out = [np.asfortranarray(e) for e in out]
        assert not out[0].flags.c_contiguous
    return out


@pytest.mark.parametrize("n", [1, 2, 32])
@pytest.mark.parametrize("case", sorted(CASES))
def test_pooled_windows_equal_the_serial_ones(pred, pred_tta, pooled, case,
                                              n):
    tta = CASES[case].get("tta", False)
    p = pred_tta if tta else pred
    streams = _case_streams(case, n, seed=11 + n)
    before = [e.copy() for e in streams]
    wins, valids, counts = _gather(p, streams)
    want = (_serial_tta if tta else _parent_recipe)(p, streams)
    assert counts == {"streams": n, "workers": min(n, 8)}
    for got, ref in zip((wins, valids), want):
        assert got.dtype == ref.dtype and got.shape == ref.shape
        np.testing.assert_array_equal(got, ref)
    # the caller's streams are never written
    for e, b in zip(streams, before):
        np.testing.assert_array_equal(e, b)


@pytest.mark.parametrize("on_pool", [False, True])
def test_the_lowest_bad_stream_is_named(pred, monkeypatch, on_pool):
    """Index 2 is empty (the shortest: the pool takes it last), index 5 a
    long stream of three columns (taken first); both routes name 2."""
    if on_pool:
        monkeypatch.setattr(serve, "WORKER_EVENTS", 1)
        monkeypatch.setattr(os, "sched_getaffinity",
                            lambda pid: set(range(4)))
    streams = _streams(21, (3000, 2000, 1000, 4000, 1500, 6000))
    streams[2] = np.zeros((0, 4), np.float32)
    streams[5] = np.zeros((90000, 3), np.float32)
    with pytest.raises(ValueError, match=r"^event_streams\[2\]: empty "):
        pred.gather_windows(streams)
    streams[2] = _some(22, (900,))[0]
    with pytest.raises(ValueError,
                       match=r"^event_streams\[5\]: expected \[n, 4\]"):
        pred.gather_windows(streams)


def test_one_stream_and_a_short_request_run_inline(pred,
                                                   windowing_threads):
    """One stream, however long, and a request under WORKER_EVENTS run on
    the calling thread with workers 1."""
    seen = windowing_threads
    long_one = _some(31, (serve.WORKER_EVENTS + 5000,))
    short = _streams(32)
    assert sum(map(len, short)) < serve.WORKER_EVENTS
    for streams in (long_one, short):
        seen.clear()
        *_, counts = _gather(pred, streams)
        assert counts == {"streams": len(streams), "workers": 1}
        assert seen == [threading.get_ident()] * len(streams)


def test_a_long_request_uses_the_pool(pred, windowing_threads):
    """Four streams of WORKER_EVENTS events each take one worker a stream,
    as many as this process has cores for, and more than one where it has
    more than one."""
    seen = windowing_threads
    streams = _some(41, (serve.WORKER_EVENTS,) * 4)
    cores = len(os.sched_getaffinity(0))
    wins, valids, counts = _gather(pred, streams)
    assert counts == {"streams": 4, "workers": min(4, cores)}
    if cores > 1:
        assert counts["workers"] > 1
        assert threading.get_ident() not in seen
    want = _parent_recipe(pred, streams)
    np.testing.assert_array_equal(wins, want[0])
    np.testing.assert_array_equal(valids, want[1])


def test_the_pool_size_follows_the_events_cores_and_streams(pred,
                                                            monkeypatch):
    monkeypatch.setattr(os, "sched_getaffinity", lambda pid: set(range(6)))
    e = serve.WORKER_EVENTS
    ones = [np.zeros((e, 4), np.float32)] * 32
    assert pred._workers(ones[:1]) == 1
    assert pred._workers([ones[0][: e // 2]] * 2) == 1
    assert pred._workers([ones[0][: e // 2]] * 3) == 2
    assert pred._workers(ones[:3]) == 3
    assert pred._workers(ones) == 6
    monkeypatch.setattr(os, "sched_getaffinity", lambda pid: {0})
    assert pred._workers(ones) == 1


def test_the_seed_of_a_fortran_stream_equals_a_c_stream(pred):
    e = _some(51, (5000,))[0]
    f, c = np.asfortranarray(e), np.ascontiguousarray(e)
    assert f.flags.f_contiguous and not f.flags.c_contiguous
    want = np.random.default_rng(zlib.crc32(c.tobytes())).integers(
        2 ** 62, size=8)
    for s in (f, c):
        ev, rng = pred._canonical(s)
        np.testing.assert_array_equal(rng.integers(2 ** 62, size=8), want)


def test_a_pooled_request_is_one_span_tree(pred, pooled):
    """The per-stream spans, opened on the workers, are children of the
    request's `serve.gather_windows` and lie inside it in time."""
    streams = _streams(61, (3000, 12000, 700, 5000, 9000, 2500, 4000))
    spans.enable()
    try:
        pred.gather_windows(streams)
    finally:
        spans.disable()
    recs = spans.records()
    root = [r for r in recs if r.name == "serve.gather_windows"]
    assert len(root) == 1
    root = root[0]
    assert root.parent is None and root.counts == {"streams": 7,
                                                   "workers": 7}
    kids = [r for r in recs if r is not root]
    assert sorted(r.name for r in kids) == sorted(
        ["serve.canonical", "serve.seed", "serve.centre", "serve.window"]
        * len(streams))
    for r in kids:
        assert r.parent == root.id and r.root == root.id
        assert root.start_ns <= r.start_ns <= r.end_ns <= root.end_ns


def test_two_handler_threads_on_the_pool_keep_two_trees(pred, pooled):
    sets = {"x": _streams(71)[:5], "y": _streams(72)[:3]}
    start = threading.Barrier(2, timeout=60)
    out, errs = {}, []

    def work(key):
        try:
            start.wait()
            out[key] = pred.gather_windows(sets[key])
        except Exception as err:  # reported below
            errs.append(err)

    spans.enable()
    threads = [threading.Thread(target=work, args=(k,)) for k in sets]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    spans.disable()
    assert not errs
    recs = spans.records()
    roots = [r for r in recs if r.name == "serve.gather_windows"]
    assert len(roots) == 2 and all(r.parent is None for r in roots)
    assert sorted(r.counts["streams"] for r in roots) == [3, 5]
    for root in roots:
        tree = [r for r in recs if r.root == root.id and r is not root]
        assert len(tree) == 4 * root.counts["streams"]
        assert all(r.parent == root.id for r in tree)
    for key, streams in sets.items():
        want = _parent_recipe(pred, streams)
        np.testing.assert_array_equal(out[key][0], want[0])
        np.testing.assert_array_equal(out[key][1], want[1])


def test_handlers_on_more_workers_than_cores_under_fast_switching(
        pred, monkeypatch):
    """Six handler threads send eighteen requests at once to one pool of
    more threads than cores, with the interpreter switching threads every
    microsecond: every request's windows equal its serial ones."""
    cores = len(os.sched_getaffinity(0))
    monkeypatch.setattr(serve, "WORKER_EVENTS", 1)
    monkeypatch.setattr(os, "sched_getaffinity",
                        lambda pid: set(range(2 * cores + 2)))
    monkeypatch.setattr(pred, "_pool", None)  # a pool of that many threads
    reqs = [_some(80 + i, (3000, 12000, 700, 5000, 9000, 2500, 4000)[i:])
            for i in range(6)]
    want = [_parent_recipe(pred, r) for r in reqs]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with ThreadPoolExecutor(6) as handlers:
            futs = [handlers.submit(pred.gather_windows, r)
                    for r in reqs * 3]
            got = [f.result(timeout=120) for f in futs]
    finally:
        sys.setswitchinterval(old)
    assert pred._pool._max_workers == 2 * cores + 2
    for (w, v), (ww, wv) in zip(got, want * 3):
        np.testing.assert_array_equal(w, ww)
        np.testing.assert_array_equal(v, wv)


def test_the_sweep_script_times_every_count_on_equal_windows(monkeypatch):
    spec = importlib.util.spec_from_file_location(
        "host_window_sweep", os.path.join(ROOT, "scripts",
                                          "host_window_sweep.py"))
    sweep = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(sweep)
    traffic = {"batch": 4, "copies": 1,
               "events": {"min": 3000, "max": 45000, "levels": 4},
               "stream": {"duration_s": 0.3, "noise": 0.2,
                          "blob_sigma": [0.05, 0.15], "drift": [0.0, 0.5]}}
    p = sweep.predictor()
    assert (p.window, p.views, tuple(p.resolution)) == (20000, 10,
                                                        (180, 240))
    res = sweep.sweep(p, traffic, [1, 2, 3], 2, seed=2 ** 31 + 3)
    assert res["events_a_request"] == sum(
        3000 + round((i + 0.5) * 42000 / 4) for i in range(4))
    assert res["picked"] == max(1, min(
        4, len(os.sched_getaffinity(0)),
        -(-res["events_a_request"] // serve.WORKER_EVENTS)))
    for k in ("1", "2", "3"):
        assert res[k]["q1_ms"] <= res[k]["median_ms"] <= res[k]["q3_ms"]
