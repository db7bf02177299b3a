"""The span recorder (eventclip_tpu_torch/utils/spans.py) and the spans of
`serve.Predictor`'s serving path, on the CPU with the ViT-T/8@32 debug
tower: the tree one request makes, its packing counts, nothing recorded
(and no clock read) while off, answers equal with recording on and off, the
ring's bound, and threads that keep their own trees."""

import threading
import time

import numpy as np
import pytest
import torch

from eventclip_tpu_torch import serve
from eventclip_tpu_torch.data.host_ops import (gather_event_windows,
                                               prepare_stream)
from eventclip_tpu_torch.data.loader import pack_view_batch
from eventclip_tpu_torch.serve import Predictor
from eventclip_tpu_torch.utils import spans
from eventclip_tpu_torch.utils.config import Params

NAMES = ["airplanes", "ant", "brain"]
LENGTHS = (600, 2800, 4100, 13700, 900, 2000)  # 1 .. 2 views of 1000


class _TinyZS(Params):
    gpus = 1
    dataset = "n_caltech"
    data_root = "/nonexistent"
    train_batch_size = 4
    val_batch_size = 8
    quantize_args = dict(
        max_imgs=2, N=1000, split_method="event_count",
        convert_method="event_histogram", grayscale=True,
        count_non_zero=False, background_mask=True,
    )
    model = "ZSCLIP"
    clip_dict = dict(arch="ViT-T/8@32", prompt="a point cloud image of a {}",
                     agg_func="mean")
    bf16 = False


def _streams(seed, lengths=LENGTHS):
    rng = np.random.default_rng(seed)
    out = [np.stack([rng.integers(0, 240, n), rng.integers(0, 180, n),
                     np.sort(rng.uniform(0, 0.3, n)),
                     rng.choice([-1.0, 1.0], n)],
                    axis=1).astype(np.float32) for n in lengths]
    out[4][:, 3] = out[4][:, 3] > 0  # a 0/1-polarity dump
    return out


@pytest.fixture(scope="module")
def pred():
    return Predictor(_TinyZS(), NAMES, smoke=True, batch_size=4,
                     device="cpu")


@pytest.fixture(scope="module")
def pred_tta(pred):
    return Predictor(_TinyZS(), NAMES, smoke=True, batch_size=4,
                     device="cpu", tta=True)


@pytest.fixture(autouse=True)
def fresh_store():
    spans.disable()
    spans.clear()
    yield
    spans.disable()
    spans.clear()


def _recorded(fn, *args, **kw):
    spans.enable()
    try:
        out = fn(*args, **kw)
    finally:
        spans.disable()
    return out, spans.records()


def _children(recs, parent):
    return [r for r in recs if r.parent == parent.id]


def _only(recs, name):
    got = [r for r in recs if r.name == name]
    assert len(got) == 1, (name, got)
    return got[0]


def _parent_recipe(pred, streams):
    """The host half as it was before it carried spans: copy and polarity,
    the content-seeded rng, centring, windowing, the stack."""
    import zlib

    wins, masks = [], []
    for e in streams:
        e = np.array(e, dtype=np.float32, copy=True)
        if e[:, 3].min() >= -0.5:
            e[:, 3] = np.where(e[:, 3] <= 0.5, -1.0, 1.0)
        rng = np.random.default_rng(zlib.crc32(
            np.ascontiguousarray(e).tobytes()))
        w, m = gather_event_windows(prepare_stream(e, pred.resolution),
                                    pred.window, pred.views, rng=rng,
                                    packed=True)
        wins.append(w)
        masks.append(m)
    return np.stack(wins), np.stack(masks)


@pytest.mark.parametrize("tta", [False, True])
def test_one_request_makes_the_span_tree(pred, pred_tta, tta):
    p = pred_tta if tta else pred
    streams = _streams(1)
    out, recs = _recorded(p.predict, streams)
    rows = 4 * len(streams) if tta else len(streams)
    chunks = -(-rows // p.batch_size)
    root = _only(recs, "serve.predict")
    assert root.parent is None and root.root == root.id
    assert {r.root for r in recs} == {root.id}
    assert len({r.id for r in recs}) == len(recs)
    assert len(recs) == 1 + 1 + 4 * len(streams) + 1 + 3 * chunks + 1

    gather = _only(recs, "serve.gather_windows")
    device = _only(recs, "serve.predict_windows")
    assert {r.id for r in _children(recs, root)} == {gather.id, device.id}
    under_gather = sorted(r.name for r in _children(recs, gather))
    assert under_gather == sorted(
        ["serve.canonical", "serve.seed", "serve.centre", "serve.window"]
        * len(streams))
    under_device = sorted(r.name for r in _children(recs, device))
    assert under_device == sorted(
        ["serve.pack", "serve.place", "serve.enqueue"] * chunks
        + ["serve.fetch"])
    by_id = {r.id: r for r in recs}
    for r in recs:  # each child inside its parent, in time
        assert r.start_ns <= r.end_ns
        if r.parent is not None:
            up = by_id[r.parent]
            assert up.start_ns <= r.start_ns and r.end_ns <= up.end_ns

    # the packing counts equal the batch's, the host half counts its
    # streams and workers (a request under WORKER_EVENTS: one); no other
    # span counts
    wins, valids = p.gather_windows(streams)
    assert sum(map(len, streams)) < serve.WORKER_EVENTS
    assert gather.counts == {"streams": len(streams), "workers": 1}
    assert not [r for r in recs if r.counts
                and r.name not in ("serve.pack", "serve.gather_windows")]
    packs = [r for r in recs if r.name == "serve.pack"]
    bs = p.batch_size
    for i, pk in enumerate(packs):
        w, v = wins[i * bs:(i + 1) * bs], valids[i * bs:(i + 1) * bs]
        pad = bs - len(w)
        w = np.concatenate([w, np.zeros((pad,) + w.shape[1:], w.dtype)])
        v = np.concatenate([v, np.zeros((pad,) + v.shape[1:], bool)])
        want = pack_view_batch({"windows": w, "valid_mask": v}, p._buckets)
        assert pk.counts == {"valid_views": int(v.sum()),
                             "packed_views": len(want["view_src"])}
    assert sum(r.counts["valid_views"] for r in packs) == int(valids.sum())
    assert out["probs"].shape == (len(streams), len(NAMES))


def test_nothing_is_recorded_and_no_clock_read_while_off(pred, monkeypatch):
    def no_clock():
        raise AssertionError("the clock was read while nothing records")

    monkeypatch.setattr(spans, "time_ns", no_clock)
    pred.predict(_streams(2))
    with spans.span("outside", n=1) as s:
        assert not s
        s.count(n=2)
    assert spans.records() == []


def test_answers_are_bit_identical_with_recording_on_and_off(pred,
                                                             pred_tta):
    streams = _streams(3)
    for p in (pred, pred_tta):
        off = p.predict(streams)
        on, recs = _recorded(p.predict, streams)
        assert recs
        np.testing.assert_array_equal(on["probs"], off["probs"])
        np.testing.assert_array_equal(on["label"], off["label"])
    # the host half is the one it was before it carried spans
    want = _parent_recipe(pred, streams)
    for record in (False, True):
        if record:
            spans.enable()
        got = pred.gather_windows(streams)
        spans.disable()
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])


def test_a_profiler_session_records_without_enable(pred):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with spans.span("inside") as s:
            assert s
        t0 = time.time_ns()
        pred.predict(_streams(4)[:2])
    t1 = time.time_ns()
    recs = spans.records()
    assert {r.name for r in recs} >= {"serve.predict", "serve.fetch"}
    # stamped on the profiler's clock: Unix-epoch ns
    for r in recs:
        assert t0 - 5_000_000 <= r.start_ns <= r.end_ns <= t1 + 5_000_000
    events = [e for e in prof.profiler.kineto_results.events()
              if e.name().startswith("aten::")]
    assert events and all(t0 - 50_000_000 < e.start_ns() < t1 + 50_000_000
                          for e in events)
    # the recorder opened no record_function range
    assert not [e for e in prof.profiler.kineto_results.events()
                if e.name().startswith("serve.")]
    spans.clear()
    pred.predict(_streams(4)[:1])
    assert spans.records() == []


def test_the_ring_keeps_the_newest_spans():
    spans.enable()
    n = spans.CAPACITY + 10
    for i in range(n):
        with spans.span("s", i=i):
            pass
    recs = spans.records()
    assert len(recs) == spans.CAPACITY
    assert [r.counts["i"] for r in recs[:2]] == [10, 11]
    assert recs[-1].counts["i"] == n - 1
    spans.clear()
    assert spans.records() == []


def test_nesting_counts_and_errors():
    spans.enable()
    with spans.span("a", x=1) as a:
        assert a
        with spans.span("b") as b:
            b.count(y=2)
        with pytest.raises(ValueError):
            with spans.span("c"):
                raise ValueError("inside c")
        a.count(z=3)
    with spans.span("d"):
        pass
    got = {r.name: r for r in spans.records()}
    assert got["a"].counts == {"x": 1, "z": 3}
    assert got["b"].counts == {"y": 2}
    assert got["b"].parent == got["c"].parent == got["a"].id
    assert got["b"].root == got["c"].root == got["a"].id
    assert got["d"].parent is None and got["d"].root == got["d"].id
    assert got["b"].end_ns >= got["b"].start_ns
    assert abs(got["d"].end_ns - time.time_ns()) < 1_000_000_000


def test_two_threads_keep_their_own_parents_and_roots(pred, monkeypatch):
    """Two threads in `gather_windows` at once: each thread's first
    windowing waits until both are inside theirs, so both trees are open
    together."""
    both = threading.Barrier(2, timeout=60)
    first = threading.local()
    orig = serve.gather_event_windows

    def meeting(*a, **kw):
        if not getattr(first, "seen", False):
            first.seen = True
            both.wait()
        return orig(*a, **kw)

    monkeypatch.setattr(serve, "gather_event_windows", meeting)
    sets = {"x": _streams(5)[:3], "y": _streams(6)[:2]}
    out, errs = {}, []

    def work(key):
        try:
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
    a, b = roots
    assert a.start_ns < b.end_ns and b.start_ns < a.end_ns  # overlapping
    by_id = {r.id: r for r in recs}
    per_root = []
    for root in roots:
        tree = [r for r in recs if r.root == root.id and r is not root]
        n = sum(r.name == "serve.canonical" for r in tree)
        assert len(tree) == 4 * n
        assert all(by_id[r.parent].root == root.id for r in tree)
        assert all(r.parent == root.id for r in tree)
        per_root.append(n)
    assert sorted(per_root) == [2, 3]
