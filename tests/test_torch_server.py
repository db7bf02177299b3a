"""The port's HTTP server (eventclip_tpu_torch/server.py) and client vs the
JAX package's.

The scenarios of tests/test_server.py whose features the port has run
against a port server on 127.0.0.1:0 and, where the answer is the model's,
against a JAX server around a Predictor on the same towers (the JAX smoke
Predictor's towers and text features cross to the port as numpy, f32):
labels, names and top-k equal, probabilities atol 1e-5
(tests/test_torch_serve.py's rule), and the embeddings (unit vectors)
to the same atol 1e-5.
Status codes and messages of the bad-request, body-limit, auth, session
and 500 cases equal the JAX server's. The MicroBatcher scenarios run with
one fake predictor on both classes and assert the same batch partitions,
with the JAX tests' own timing margins.
"""

import ast
import gzip
import io
import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest

from eventclip_tpu import server as ref_server
from eventclip_tpu.serve import Predictor as RefPredictor
from eventclip_tpu_torch import client, serve, server
from eventclip_tpu_torch.client import ServingClient, ServingError
from eventclip_tpu_torch.serve import Predictor, StreamSession
from eventclip_tpu_torch.utils.config import Params

from .test_server import _TinyZS as _RefTinyZS
from .test_server import NAMES, _streams
from .test_tokenizer import MERGES

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class _TinyZS(Params):
    """tests/test_server.py's `_TinyZS`, through the port's config class."""
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
    clip_dict = dict(arch="ViT-T/8@32",
                     prompt="a point cloud image of a {}",
                     agg_func="mean")
    bf16 = False


@pytest.fixture(scope="module")
def ref_pred():
    return RefPredictor(_RefTinyZS(), class_names=NAMES, smoke=True,
                        batch_size=4, embed=True)


def _port(ref, **kw):
    tree = jax.tree_util.tree_map(np.asarray, ref._params["clip"])
    return Predictor(_TinyZS(), NAMES, clip_params=tree,
                     text_feats=np.asarray(ref._params["text_feats"]),
                     batch_size=4, device="cpu", **kw)


def _start(srv):
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return f"http://127.0.0.1:{srv.server_address[1]}"


@pytest.fixture(scope="module")
def pair(ref_pred):
    """(port predictor, port URL, JAX predictor, JAX URL), embeddings on."""
    port = _port(ref_pred, embed=True)
    a = server.make_server(port, "127.0.0.1", 0)
    b = ref_server.make_server(ref_pred, "127.0.0.1", 0)
    yield port, _start(a), ref_pred, _start(b)
    a.shutdown()
    b.shutdown()


def _call(url, body=None, ctype="application/json", method=None,
          headers=None):
    """-> (status, decoded JSON) for successes and HTTP errors alike."""
    h = {"Content-Type": ctype} if body is not None else {}
    h.update(headers or {})
    req = urllib.request.Request(url, data=body, headers=h, method=method)
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _same_answer(got, want, probs=True):
    assert got["label"] == want["label"]
    assert got["names"] == want["names"]
    assert got["topk"] == want["topk"]
    if probs:
        np.testing.assert_allclose(np.asarray(got["probs"]),
                                   np.asarray(want["probs"]), atol=1e-5,
                                   rtol=0)


def test_healthz_and_classes_equal_jax(pair):
    _, url, _, ref_url = pair
    for route in ("/healthz", "/classes"):
        got, want = _call(url + route), _call(ref_url + route)
        assert got == want, route
    assert got[1]["classes"] == NAMES


def test_predict_json_matches_jax(pair):
    port, url, _, ref_url = pair
    streams = _streams(np.random.default_rng(3), 5)  # a padded chunk
    body = json.dumps({"streams": [s.tolist() for s in streams],
                       "top_k": 2, "return_probs": True}).encode()
    (code, got), (rcode, want) = (_call(url + "/predict", body),
                                  _call(ref_url + "/predict", body))
    assert code == rcode == 200
    _same_answer(got, want)
    direct = port.predict(streams, top_k=2)
    assert got["label"] == direct["label"].tolist()
    np.testing.assert_array_equal(np.asarray(got["probs"], np.float32),
                                  direct["probs"])


@pytest.mark.parametrize("positional", [False, True],
                         ids=["named", "positional"])
def test_predict_npz_matches_jax(pair, positional):
    """x-npz bodies; np.savez(buf, *streams) names arrays arr_0..arr_11,
    which the decode keeps in archive order."""
    _, url, _, ref_url = pair
    streams = _streams(np.random.default_rng(7), 12 if positional else 3)
    buf = io.BytesIO()
    if positional:
        np.savez(buf, *streams)
    else:
        np.savez(buf, **{f"s{i}": s for i, s in enumerate(streams)})
    q = "/predict?top_k=2&return_probs=1"
    got = _call(url + q, buf.getvalue(), "application/x-npz")
    want = _call(ref_url + q, buf.getvalue(), "application/x-npz")
    assert got[0] == want[0] == 200
    _same_answer(got[1], want[1])


def test_probs_omitted_by_default(pair):
    _, url, _, ref_url = pair
    s = _streams(np.random.default_rng(9), 1)
    body = json.dumps({"streams": [x.tolist() for x in s]}).encode()
    got, want = _call(url + "/predict", body), _call(ref_url + "/predict",
                                                     body)
    assert got == want and "probs" not in got[1]


def _bad_requests():
    good = _streams(np.random.default_rng(1), 1)[0]
    s = json.dumps({"streams": [good.tolist()]}).encode()
    return [
        ("/predict", b"{not json", "application/json"),
        ("/predict", json.dumps({"x": 1}).encode(), "application/json"),
        ("/predict", json.dumps({"streams": [good.tolist(), []]}).encode(),
         "application/json"),
        ("/predict", json.dumps({"streams": [[["a", 1, 2, 3]]]}).encode(),
         "application/json"),
        ("/predict", b"\x00\x01", "application/x-npz"),
        ("/predict", b"", "application/json"),
        ("/predict?top_k=abc", s, "application/json"),
        ("/predict", json.dumps({"streams": [good.tolist()],
                                 "top_k": None}).encode(),
         "application/json"),
        ("/nope", s, "application/json"),
        ("/session/deadbeef/predict", b"", "application/json"),
        ("/session/x/y/z", b"", "application/json"),
        ("/session", json.dumps({"horizon": 1}).encode(), "application/json"),
        ("/session", json.dumps({"horizon": 10 ** 9}).encode(),
         "application/json"),
        ("/session", b"[1]", "application/json"),
        ("/set_classes", json.dumps({"classes": []}).encode(),
         "application/json"),
        ("/set_classes", json.dumps({"classes": [1, 2]}).encode(),
         "application/json"),
    ]


def test_bad_requests_equal_jax(pair):
    """Every bad request gets the JAX server's status and message."""
    _, url, _, ref_url = pair
    for route, body, ctype in _bad_requests():
        got = _call(url + route, body, ctype)
        want = _call(ref_url + route, body, ctype)
        assert got[0] >= 400, (route, got)
        assert got == want, (route, body[:40], got, want)
    for route in ("/nope", "/session/deadbeef"):
        assert _call(url + route) == _call(ref_url + route)
        assert _call(url + route, method="DELETE") == _call(
            ref_url + route, method="DELETE")


def test_body_size_limit_equals_jax(pair):
    port, _, ref, _ = pair
    a = server.make_server(port, "127.0.0.1", 0, max_body=64)
    b = ref_server.make_server(ref, "127.0.0.1", 0, max_body=64)
    try:
        body = json.dumps({"streams": [[[0, 0, 0.0, 1]] * 100]}).encode()
        got, want = (_call(_start(a) + "/predict", body),
                     _call(_start(b) + "/predict", body))
        assert got == want and got[0] == 413
    finally:
        a.shutdown()
        b.shutdown()


def test_unexpected_predictor_error_returns_500(pair):
    port, url, ref, ref_url = pair
    body = json.dumps({"streams": [s.tolist() for s in _streams(
        np.random.default_rng(23), 1)]}).encode()

    def boom(*a, **kw):
        raise RuntimeError("device fell over")

    port.predict, ref.predict = boom, boom
    try:
        got, want = (_call(url + "/predict", body),
                     _call(ref_url + "/predict", body))
    finally:
        del port.predict, ref.predict
    assert got == want and got[0] == 500 and "device fell over" in got[1][
        "error"]
    assert _call(url + "/predict", body)[0] == 200  # still alive


def test_auth_token_equals_jax(pair):
    port, _, ref, _ = pair
    a = server.make_server(port, "127.0.0.1", 0, auth_token="sekrit")
    b = ref_server.make_server(ref, "127.0.0.1", 0, auth_token="sekrit")
    try:
        ua, ub = _start(a), _start(b)
        for hdr in ({}, {"Authorization": "Bearer wrong"}):
            got = _call(ua + "/healthz", headers=hdr)
            assert got == _call(ub + "/healthz", headers=hdr)
            assert got[0] == 401
        with pytest.raises(ServingError) as e:
            ServingClient(ua).health()
        assert e.value.status == 401
        c = ServingClient(ua, auth_token="sekrit")
        assert c.health()["status"] == "ok"
        out = c.predict(_streams(np.random.default_rng(53), 2))
        assert out["label"].shape == (2,)
    finally:
        a.shutdown()
        b.shutdown()


def test_serving_client_and_statz(pair):
    port, url, _, _ = pair
    c = ServingClient(url)
    assert c.health()["status"] == "ok" and c.classes() == NAMES
    streams = _streams(np.random.default_rng(41), 5)
    before = c.stats()
    out = c.predict(streams, top_k=2, return_probs=True)
    direct = port.predict(streams, top_k=2)
    np.testing.assert_array_equal(out["label"], direct["label"])
    assert out["names"] == direct["names"]
    np.testing.assert_array_equal(out["topk"], direct["topk"])
    np.testing.assert_array_equal(out["probs"], direct["probs"])
    assert "probs" not in c.predict(streams[:1])
    with pytest.raises(ServingError, match=r"event_streams\[1\]"):
        c.predict([streams[0], np.zeros((0, 4), np.float32)])
    after = c.stats()
    assert after["predict_requests"] == before["predict_requests"] + 2
    assert after["streams"] == before["streams"] + 6
    assert after["errors"] == before["errors"] + 1
    lat = after["latency_ms"]
    assert lat["window"] >= 1 and lat["p50"] <= lat["p95"] <= lat["max"]


def test_client_is_the_jax_client():
    """The port's client is a copy of eventclip_tpu/client.py, apart from
    the module docstring."""
    import eventclip_tpu.client as ref_client

    def body(mod):
        with open(mod.__file__) as f:
            tree = ast.parse(f.read())
        tree.body = tree.body[1:]  # the module docstring
        return ast.dump(tree)

    assert body(client) == body(ref_client)


def test_embed_route_matches_jax(pair):
    _, url, _, ref_url = pair
    streams = _streams(np.random.default_rng(74), 3)
    got = ServingClient(url).embed(streams)
    want = ServingClient(ref_url).embed(streams)
    assert got.shape == want.shape == (3, 32)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


class _NoEmbed:
    """A predictor as far as make_server and the /embed refusal read it."""
    _embed = False
    _embed_step = None
    views, window = 2, 1000


def test_embed_route_disabled_is_400_as_jax():
    a = server.make_server(_NoEmbed(), "127.0.0.1", 0)
    b = ref_server.make_server(_NoEmbed(), "127.0.0.1", 0)
    try:
        body = json.dumps({"streams": [[[1, 1, 0.0, 1]]]}).encode()
        got, want = (_call(_start(a) + "/embed", body),
                     _call(_start(b) + "/embed", body))
        assert got == want and got[0] == 400 and "--embed" in got[1]["error"]
    finally:
        a.shutdown()
        b.shutdown()


@pytest.fixture
def vocab(tmp_path, monkeypatch):
    path = tmp_path / "bpe_simple_vocab_16e6.txt.gz"
    with gzip.open(path, "wt", encoding="utf-8") as f:
        f.write("#version: tiny\n"
                + "\n".join(f"{a} {b}" for a, b in MERGES))
    monkeypatch.setenv("EVENTCLIP_BPE_PATH", str(path))
    return str(path)


def test_set_classes_route_matches_jax(ref_pred, vocab):
    ref = RefPredictor(_RefTinyZS(), class_names=NAMES, smoke=True,
                       batch_size=4)
    port = _port(ref)
    a = server.make_server(port, "127.0.0.1", 0)
    b = ref_server.make_server(ref, "127.0.0.1", 0)
    try:
        ca, cb = ServingClient(_start(a)), ServingClient(_start(b))
        new = ["cup", "chair", "lamp", "pizza"]
        assert ca.set_classes(new) == cb.set_classes(new) == new
        assert ca.classes() == new and ca.health()["n_classes"] == 4
        streams = _streams(np.random.default_rng(77), 3)
        got = ca.predict(streams, top_k=2, return_probs=True)
        want = cb.predict(streams, top_k=2, return_probs=True)
        np.testing.assert_array_equal(got["label"], want["label"])
        assert got["names"] == want["names"]
        np.testing.assert_array_equal(got["topk"], want["topk"])
        np.testing.assert_allclose(got["probs"], want["probs"], atol=1e-5,
                                   rtol=0)
    finally:
        a.shutdown()
        b.shutdown()


def test_set_classes_rejected_with_microbatcher_as_jax(pair):
    port, _, ref, _ = pair
    a = server.make_server(port, "127.0.0.1", 0, microbatch_ms=20.0)
    b = ref_server.make_server(ref, "127.0.0.1", 0, microbatch_ms=20.0)
    try:
        body = json.dumps({"classes": ["x", "y"]}).encode()
        got, want = (_call(_start(a) + "/set_classes", body),
                     _call(_start(b) + "/set_classes", body))
        assert got == want and got[0] == 409 and "microbatch" in got[1][
            "error"]
    finally:
        a.shutdown()
        b.shutdown()


# -- streaming sessions -----------------------------------------------------------


def test_streaming_session_http_matches_jax(pair):
    """Open, chunked appends (one piggybacking a rolling prediction),
    predict-only, info, close: the port's answers equal the JAX server's
    and Predictor.predict on the buffered events."""
    port, url, _, ref_url = pair
    stream = _streams(np.random.default_rng(21), 1)[0]
    chunks = np.array_split(stream, 3)
    rolled = []
    for u in (url, ref_url):
        with ServingClient(u).open_session() as sess:
            assert sess.horizon == port.views * port.window
            r = sess.append(chunks[0])
            assert r == {"n_events": len(chunks[0]), "horizon": sess.horizon}
            sess.append(chunks[1])
            r = sess.append(chunks[2], predict=True, top_k=2)
            r2 = sess.predict(top_k=2)
            assert r2["label"] == r["label"] and r2["topk"] == r["topk"]
            assert sess.info() == {"n_events": len(stream),
                                   "horizon": sess.horizon}
            sid = sess.session_id
        assert _call(f"{u}/session/{sid}")[0] == 404
        rolled.append(r)
    got, want = rolled
    assert got["label"] == want["label"] and got["name"] == want["name"]
    assert got["topk"] == want["topk"]
    np.testing.assert_allclose(got["probs"], want["probs"], atol=1e-5,
                               rtol=0)
    direct = port.predict([stream], top_k=2)
    np.testing.assert_array_equal(np.asarray(got["probs"], np.float32),
                                  direct["probs"][0])


def test_streaming_session_errors_equal_jax(pair):
    """Empty buffer 409, malformed chunk 400, bad top_k 400, empty
    heartbeats, and an append whose prediction fails returns 200 with
    `predict_error`: statuses and messages as the JAX server's."""
    port, url, ref, ref_url = pair
    seen = []
    for u, p in ((url, port), (ref_url, ref)):
        c = ServingClient(u)
        sess = c.open_session(horizon=2000)
        sid = sess.session_id
        calls = [
            (f"/session/{sid}/predict", b"", "application/json"),
            (f"/session/{sid}/events", json.dumps(
                {"events": np.zeros((5, 3)).tolist()}).encode(),
             "application/json"),
            (f"/session/{sid}/events", b"{bad", "application/json"),
            (f"/session/{sid}/events", json.dumps({"events": []}).encode(),
             "application/json"),
            (f"/session/{sid}/predict", json.dumps(
                {"top_k": "abc"}).encode(), "application/json"),
        ]
        out = [_call(u + r, b, t) for r, b, t in calls]

        def boom(*a, **k):
            raise RuntimeError("injected device failure")

        p.predict = boom
        try:
            out.append(sess.append(np.zeros((7, 4), np.float32),
                                   predict=True))
        finally:
            del p.predict
        out.append(sess.info())
        sess.close()
        seen.append(out)
    assert seen[0] == seen[1]
    assert [o[0] for o in seen[0][:5]] == [409, 400, 400, 200, 400]
    assert "injected device failure" in seen[0][5]["predict_error"]


def test_streaming_session_ttl_and_cap_equal_jax(pair):
    port, _, ref, _ = pair
    seen = []
    for mod, p in ((server, port), (ref_server, ref)):
        srv = mod.make_server(p, "127.0.0.1", 0, session_ttl_s=0.2,
                              max_sessions=1)
        try:
            c = ServingClient(_start(srv))
            sess = c.open_session()
            out = [_call(c.base_url + "/session", b"")]
            out.append(c.stats()["sessions"])
            time.sleep(0.3)
            out.append(_call(f"{c.base_url}/session/{sess.session_id}"))
            c.open_session().close()
            out.append(c.stats()["sessions"])
        finally:
            srv.shutdown()
        seen.append(out)
    assert seen[0] == seen[1]
    assert seen[0][0][0] == 429 and seen[0][1] == 1 and seen[0][3] == 0


# -- the micro-batcher ----------------------------------------------------------


class _Fake:
    """A predictor without a model: one window row per stream (4 with TTA),
    probabilities a function of each stream's first event, so a request's
    answer never depends on its batchmates. Records the rows of every
    fused device call."""

    class_names = ["a", "b", "c"]
    tta = False

    def __init__(self, batch_size=4, gather_delay=None, tta=False):
        self.batch_size = batch_size
        self.tta = tta
        self.calls = []
        self._delay = gather_delay or (lambda streams: None)

    def gather_windows(self, streams):
        for i, s in enumerate(streams):
            if len(s) == 0:
                raise ValueError(f"event_streams[{i}]: empty event stream")
        self._delay(streams)
        rep = 4 if self.tta else 1
        rows = np.repeat(np.stack([s[0, :3] for s in streams]), rep, 0)
        return rows.astype(np.float32), np.ones((len(rows), 1), bool)

    def predict_windows(self, wins, valids, top_k=1):
        self.calls.append(len(wins))
        logits = np.stack([wins[:, 0], -wins[:, 0], wins[:, 1]], -1)
        p = np.exp(logits - logits.max(-1, keepdims=True))
        p /= p.sum(-1, keepdims=True)
        if self.tta:
            p = p.reshape(-1, 4, 3).mean(1)
        return {"probs": p.astype(np.float32)}

    def predict(self, streams, top_k=1):
        if not len(streams):
            return {"label": np.zeros((0,), np.int64), "names": [],
                    "probs": np.zeros((0, 3), np.float32),
                    "topk": np.zeros((0, min(top_k, 3)), np.int64)}
        return self.predict_windows(*self.gather_windows(streams))


def _fake_streams(n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(5, 4)).astype(np.float32) for _ in range(n)]


BATCHERS = pytest.mark.parametrize(
    "batcher", [server.MicroBatcher, ref_server.MicroBatcher],
    ids=["port", "jax"])


def _burst(mb, streams, top_k=1):
    out = [None] * len(streams)

    def go(i):
        out[i] = mb.submit([streams[i]], top_k=top_k)

    ts = [threading.Thread(target=go, args=(i,)) for i in range(len(streams))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=30)
    return out


@BATCHERS
def test_microbatcher_direct_api(batcher):
    """tests/test_server.py:250 with the fake predictor."""
    pred = _Fake()
    mb = batcher(pred, max_wait_ms=5.0)
    try:
        streams = _fake_streams(3)
        out = mb.submit(streams, top_k=2)
        direct = pred.predict_windows(*pred.gather_windows(streams))
        np.testing.assert_array_equal(out["probs"], direct["probs"])
        assert out["topk"].shape == (3, 2)
        assert mb.submit([], top_k=1)["probs"].shape == (0, 3)
        with pytest.raises(ValueError, match=r"event_streams\[1\]"):
            mb.submit([streams[0], np.zeros((0, 4), np.float32)])
    finally:
        mb.close()
    with pytest.raises(RuntimeError):
        mb.submit(streams)


@BATCHERS
def test_microbatcher_adaptive_gap_lone_request_fast(batcher):
    """tests/test_server.py:327: a 30 s cap, a 50 ms idle gap."""
    mb = batcher(_Fake(), max_wait_ms=30_000.0, idle_gap_ms=50.0)
    try:
        t0 = time.monotonic()
        assert len(mb.submit(_fake_streams(1))["label"]) == 1
        assert time.monotonic() - t0 < 10.0
    finally:
        mb.close()


@BATCHERS
def test_microbatcher_fuses_staggered_burst_into_one_call(batcher):
    """tests/test_server.py:348: gathers staggered 30 ms apart, idle gap
    10 ms, cap 5 s: one fused call of 8 rows."""
    pred = _Fake(batch_size=8, gather_delay=lambda s: time.sleep(0.03))
    mb = batcher(pred, max_wait_ms=5_000.0, idle_gap_ms=10.0)
    try:
        _burst(mb, _fake_streams(8))
    finally:
        mb.close()
    assert pred.calls == [8]
    assert len(mb.batch_log) == 1
    entry = mb.batch_log[0]
    assert entry["requests"] == 8 and entry["streams"] == 8
    assert entry["window_ms"] >= 25.0 and entry["device_ms"] >= 0.0
    for k in ("close_ms", "lock_ms", "slice_ms"):
        assert entry[k] >= 0.0, (k, entry)


@BATCHERS
def test_microbatcher_cap_rearms_while_windowing_progresses(batcher):
    """tests/test_server.py:402: ready flips 70 ms apart under a 100 ms
    cap re-arm it, so the 4-burst fuses into one call."""
    streams = _fake_streams(4)
    idx = {id(s): i for i, s in enumerate(streams)}
    pred = _Fake(gather_delay=lambda s: time.sleep(0.07 * idx[id(s[0])]))
    mb = batcher(pred, max_wait_ms=100.0, idle_gap_ms=10.0)
    try:
        _burst(mb, streams)
    finally:
        mb.close()
    assert pred.calls == [4]


@BATCHERS
def test_microbatcher_hard_cap_leaves_stragglers_for_next_batch(batcher):
    """tests/test_server.py:451: at the cap the ready requests run; the
    straggler is served by a later batch."""
    streams = _fake_streams(3)
    release = threading.Event()

    def gate(s):
        if len(s) == 1 and s[0] is streams[2]:
            release.wait(timeout=30)

    pred = _Fake(gather_delay=gate)
    mb = batcher(pred, max_wait_ms=100.0, idle_gap_ms=20.0)
    results = {}

    def go(i):
        results[i] = mb.submit([streams[i]])

    try:
        ts = [threading.Thread(target=go, args=(i,)) for i in range(3)]
        for t in ts:
            t.start()
        time.sleep(0.5)
        assert 0 in results and 1 in results and 2 not in results
        release.set()
        for t in ts:
            t.join(timeout=30)
    finally:
        release.set()
        mb.close()
    assert pred.calls == [2, 1]
    np.testing.assert_array_equal(
        results[2]["probs"],
        pred.predict_windows(*pred.gather_windows([streams[2]]))["probs"])


@BATCHERS
@pytest.mark.parametrize("tta", [False, True])
def test_microbatcher_default_cap_counts_streams(batcher, tta):
    """tests/test_server.py:791: 8 chunks' worth of streams, a TTA stream
    spanning 4 rows."""
    mb = batcher(_Fake(batch_size=8, tta=tta), max_wait_ms=1.0)
    try:
        assert mb._max == (2 * 8 if tta else 8 * 8)
    finally:
        mb.close()


def test_microbatch_http_fuses_and_matches_jax(pair):
    """Concurrent single-stream HTTP requests fuse into fewer device calls,
    each answer equal to the JAX Predictor's on its stream."""
    port, _, ref, _ = pair
    srv = server.make_server(port, "127.0.0.1", 0, microbatch_ms=25.0)
    url = _start(srv)
    streams = _streams(np.random.default_rng(11), 6)
    want = [ref.predict([s], top_k=2) for s in streams]
    calls = []
    inner = port.predict_windows
    port.predict_windows = lambda *a, **kw: (calls.append(1),
                                             inner(*a, **kw))[1]
    try:
        out = [None] * len(streams)

        def fire(i):
            out[i] = ServingClient(url).predict([streams[i]], top_k=2,
                                                return_probs=True)

        ts = [threading.Thread(target=fire, args=(i,)) for i in range(6)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        # a bad stream fails only its own request
        with pytest.raises(ServingError, match=r"event_streams\[0\]"):
            ServingClient(url).predict([np.zeros((0, 4), np.float32)])
    finally:
        del port.predict_windows
        srv.shutdown()
    for o, w in zip(out, want):
        np.testing.assert_array_equal(o["label"], w["label"])
        np.testing.assert_array_equal(o["topk"], w["topk"])
        np.testing.assert_allclose(o["probs"], w["probs"], atol=1e-5, rtol=0)
    assert len(calls) < len(streams)


def test_microbatcher_with_tta_predictor(ref_pred):
    port = _port(ref_pred, tta=True)
    streams = _streams(np.random.default_rng(67), 4)
    direct = port.predict(streams, top_k=2)
    mb = server.MicroBatcher(port, max_wait_ms=200.0, idle_gap_ms=50.0)
    try:
        out = _burst(mb, streams, top_k=2)
    finally:
        mb.close()
    for i, r in enumerate(out):
        np.testing.assert_allclose(r["probs"][0], direct["probs"][i],
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(r["label"], direct["label"][i:i + 1])


def test_make_server_plumbs_idle_gap(pair):
    srv = server.make_server(pair[0], "127.0.0.1", 0, microbatch_ms=50.0,
                             microbatch_idle_ms=5.0)
    try:
        assert abs(srv.batcher._wait - 0.050) < 1e-9
        assert abs(srv.batcher._gap - 0.005) < 1e-9
    finally:
        srv.batcher.close()
        srv.server_close()


def test_drain_waits_for_inflight_request(pair):
    port = pair[0]
    inner = port.predict

    def slow_predict(streams, top_k=1):
        time.sleep(0.8)
        return inner(streams, top_k=top_k)

    port.predict = slow_predict
    srv = server.make_server(port, "127.0.0.1", 0)
    url = _start(srv)
    result = {}
    try:
        rt = threading.Thread(target=lambda: result.setdefault(
            "out", ServingClient(url).predict(_streams(
                np.random.default_rng(73), 1))))
        rt.start()
        time.sleep(0.3)
        t0 = time.monotonic()
        assert srv.drain() is True
        waited = time.monotonic() - t0
        rt.join(10)
    finally:
        del port.predict
        srv.server_close()
    assert "out" in result and waited >= 0.2


# -- the serve.py seams the server uses ------------------------------------------


def test_stream_session_predict_fn_routes_the_device_entry(pair):
    port = pair[0]
    stream = _streams(np.random.default_rng(5), 1)[0]
    sess = StreamSession(port)
    sess.append(stream)
    seen = []

    def fn(streams, top_k=1):
        seen.append((len(streams[0]), top_k))
        return port.predict(streams, top_k=top_k)

    got = sess.predict(top_k=2, predict_fn=fn)
    assert seen == [(len(stream), 2)]
    want = sess.predict(top_k=2)
    np.testing.assert_array_equal(got["probs"], want["probs"])
    assert got["n_events"] == len(stream) and got["topk"].shape == (2,)


@pytest.mark.parametrize("batch_size,tta", [(16, False), (6, True)])
def test_warm_up_logs_and_covers_every_bucket(ref_pred, monkeypatch, capsys,
                                              batch_size, tta):
    """server._warm_up runs Predictor.warm_up(log=print): one chunk per
    packing bucket (with TTA at an odd batch too), each logged."""
    tree = jax.tree_util.tree_map(np.asarray, ref_pred._params["clip"])
    pred = Predictor(_TinyZS(), NAMES, clip_params=tree,
                     text_feats=np.asarray(ref_pred._params["text_feats"]),
                     batch_size=batch_size, tta=tta, device="cpu")
    assert len(pred._buckets) > 1
    seen = []
    orig = serve.pack_view_batch

    def spy(batch, buckets):
        out = orig(batch, buckets)
        if "view_src" in out:
            seen.append(int(out["windows"].shape[0]))
        return out

    monkeypatch.setattr(serve, "pack_view_batch", spy)
    server._warm_up(pred)
    logged = capsys.readouterr().out.splitlines()
    assert set(seen) == set(pred._buckets)
    assert len(logged) == len(pred._buckets)
    assert all(m.startswith("warm-up: program") for m in logged)


# -- the CLI -------------------------------------------------------------------------


def test_server_cli_refuses_data_parallel_and_baked_flags():
    with pytest.raises(SystemExit):  # exactly one model source
        server.main(["--cpu"])
    with pytest.raises(SystemExit):
        server.main(["--from_export", "b.eclip", "--int8", "--cpu"])
    assert server.resolve_class_names is serve.resolve_class_names


def test_server_cli_serves_and_drains_on_sigterm(tmp_path):
    """`python -m eventclip_tpu_torch.server --cpu`: warms up, serves a
    request, and a SIGTERM drains it to a clean exit."""
    names = tmp_path / "names.txt"
    names.write_text("\n".join(NAMES) + "\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    proc = subprocess.Popen(
        [sys.executable, "-m", "eventclip_tpu_torch.server", "--params",
         os.path.join(ROOT, "configs/debug/zsclip_tiny_params.py"),
         "--classes", str(names), "--smoke", "--cpu", "--port", "0",
         "--batch_size", "4", "--microbatch_ms", "20"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    try:
        url = None
        for line in proc.stdout:
            if line.startswith("serving "):
                url = line.split(" on ")[1].split()[0]
                break
        assert url, "the server never came up"
        out = ServingClient(url).predict(_streams(np.random.default_rng(2),
                                                  2))
        assert out["label"].shape == (2,)
        proc.send_signal(signal.SIGTERM)
        rest = proc.communicate(timeout=60)[0]
        assert proc.returncode == 0 and "server stopped" in rest, rest
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
