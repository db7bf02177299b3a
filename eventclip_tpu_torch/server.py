"""HTTP serving endpoint: `python -m eventclip_tpu_torch.server`.

Port of eventclip_tpu/server.py. `serve.Predictor` (or an
`export.ExportedPredictor`, with `--from_export`) packages the eval
pipeline as a batch API on the card; this module puts an endpoint in front
of it using only the standard library (the handler is a thin request
decoder around one Predictor call). Routes, status codes and messages are
the JAX package's.

Routes:

- ``GET /healthz``  -> ``{"status": "ok", model, arch, n_classes, batch_size}``
- ``GET /classes``  -> ``{"classes": [...]}``
- ``GET /statz``    -> serving counters + rolling latency percentiles
- ``POST /predict`` -> classification. Two request encodings:

  * ``application/json`` (default): ``{"streams": [[[x, y, t, p], ...],
    ...], "top_k": 1, "return_probs": false}``
  * ``application/x-npz``: an ``np.savez`` archive whose arrays (any key
    names; request order = the order the arrays were saved in) are the
    ``[n, 4]`` float streams — far smaller on the wire than JSON for
    real sensor dumps. ``top_k`` / ``return_probs`` ride the query
    string.

  Response: ``{"label": [B], "names": [B], "topk": [B, k]}`` (+ ``"probs"``
  [B, C] when requested), rows aligned with the request order.

- streaming sessions (live sensor feeds; serve.StreamSession server-side):

  * ``POST /session`` ``{"horizon": N?}`` -> ``{"session_id", "horizon"}``
  * ``POST /session/<id>/events`` (JSON ``{"events": [[x,y,t,p], ...],
    "predict": false, "top_k": 1}`` or an x-npz archive with ONE array;
    ``predict``/``top_k`` may ride the query string) appends a chunk ->
    ``{"n_events", "horizon"}``, plus the rolling prediction fields when
    ``predict`` is set. A combined append+predict whose prediction fails
    still returns 200 with the append result plus ``"predict_error"`` —
    the append took effect, and retrying an error response must not
    double-append.
  * ``POST /session/<id>/predict`` -> ``{"label", "name", "topk",
    "probs", "n_events"}`` without appending
  * ``GET /session/<id>`` (buffer stats) / ``DELETE /session/<id>``

  Sessions expire after ``--session_ttl`` idle seconds and are capped at
  ``--max_sessions`` (429); a client-requested horizon is capped at
  ``--max_horizon`` (400 past it — buffers are server memory). Rolling
  predictions share /predict's device path (they fuse through the
  micro-batcher when it is on).

Bad inputs return 400 with the offending stream index in the message
(Predictor validates per-stream); oversized bodies return 413. By default
requests are serialized through one lock — the card processes one batch
at a time anyway, so batch multiple streams into ONE request to use it
well. Under concurrent single-stream load, start with ``--microbatch_ms``:
requests arriving within the window fuse into one device batch
(MicroBatcher below), turning N serialized forwards into one.
"""

from __future__ import annotations

import argparse
import io
import json
import math
import os
import threading
import time
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Sequence

import numpy as np

from .serve import Predictor, StreamSession, resolve_class_names
from .utils.config import load_params

DEFAULT_MAX_BODY = 512 * 1024 * 1024  # 512 MiB


class MicroBatcher:
    """Fuses concurrent predict requests into one device batch.

    Without it, N concurrent single-stream requests serialize through the
    handler lock at one forward each; fused, they ride the same
    throughput path a single N-stream request does (the card processes a
    [batch_size, ...] batch either way; chip_smoke.py phase 12 measures
    the two regimes on the card). The host half (validation + window
    gathering) stays on each request's own handler thread; only the
    device phase is fused, on the worker thread (the predictor's device
    step enters inference mode itself, which is per-thread state).

    A request REGISTERS with the worker the instant it arrives, then
    windows its streams on its own handler thread and flips to ready.
    The worker's batch-closing clock therefore runs on request
    *arrivals*, not on windowing *completions*: a 32-request burst is
    visible as 32 registrations within a millisecond, and the worker
    holds the batch open while any of them is still windowing (GIL
    contention staggers completions over tens of ms — closing on a
    completion gap fires a 1-row batch that costs a full padded
    forward and serializes the other 31 behind it). The batch closes
    when every registered request is ready and a quiet ``idle_gap_ms``
    passes with no new arrival, or at the ``max_wait_ms`` cap (taking
    only the ready ones), or at ``max_streams`` ready. The cap RE-ARMS
    on every new ready flip while peers are still windowing: on a
    loaded 1-core host a 32-burst's GIL-serialized windowing can
    outlast any fixed cap, and closing mid-burst pays a second full
    padded forward for the stragglers. Flips are progress — the
    device is idle anyway — so the cap only fires after ``max_wait_ms``
    with *no* request completing windowing, which is the genuinely
    stalled-straggler case it exists for. One
    ``Predictor.predict_windows`` call then serves the whole batch and
    the probabilities are sliced back per request. A lone request waits
    only ~idle_gap_ms. Per-request ``top_k`` is honored by recomputing
    the cheap argsort on the host.
    """

    def __init__(self, predictor, max_wait_ms: float = 2.0,
                 max_streams: Optional[int] = None,
                 idle_gap_ms: Optional[float] = None,
                 device_lock: Optional[threading.Lock] = None):
        self._pred = predictor
        # the worker holds this around its fused device phase; sharing it
        # with the handler lock keeps non-fused device routes (/embed)
        # serialized against fused predicts — the card runs one batch at a
        # time (two batches in flight would double the activation memory)
        self._device_lock = device_lock or threading.Lock()
        self._wait = max(float(max_wait_ms), 0.0) / 1e3
        self._gap = (max(float(idle_gap_ms), 0.0) / 1e3
                     if idle_gap_ms is not None else self._wait / 4)
        # default cap = 8 device chunks worth of streams (a TTA stream
        # spans 4 device rows, so divide the row budget accordingly)
        rows_per_stream = 4 if getattr(predictor, "tta", False) else 1
        self._max = int(max_streams
                        or 8 * predictor.batch_size // rows_per_stream or 1)
        self._cond = threading.Condition()
        self._pending: list = []
        self._arrivals = 0  # monotone registration counter (gap clock)
        self._closed = False
        # per-fused-batch phase timings (chip_smoke.py phase 12 reads this
        # to attribute where a fused cycle's time goes)
        self.batch_log: deque = deque(maxlen=64)
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    def close(self) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        self._worker.join(timeout=30)

    def submit(self, event_streams, top_k: int = 1):
        """Blocking predict through the fuser; same contract as
        Predictor.predict (including the indexed ValueError on bad
        streams, raised from submit itself — a bad request never reaches
        the device phase and never fails its batchmates)."""
        if not len(event_streams):
            return self._pred.predict([], top_k=top_k)
        # register BEFORE windowing so the worker's gap clock sees the
        # arrival now; the windowing (host-side, GIL-contended under
        # concurrent load) happens on this thread, then flips ready
        req = _Request(wins=None, valids=None, top_k=int(top_k),
                       n_streams=len(event_streams))
        with self._cond:
            if self._closed:
                raise RuntimeError("MicroBatcher is closed")
            self._pending.append(req)
            self._arrivals += 1
            self._cond.notify_all()
        try:
            # with TTA each stream spans 4 device rows; predict_windows
            # collapses them, so result slicing goes by stream count
            req.wins, req.valids = self._pred.gather_windows(event_streams)
        except BaseException:
            with self._cond:  # un-register: the worker never takes a
                if req in self._pending:  # non-ready request
                    self._pending.remove(req)
                self._cond.notify_all()
            raise
        with self._cond:
            req.ready = True
            req.t_ready = time.monotonic()
            self._cond.notify_all()
        req.done.wait()
        if req.err is not None:
            raise req.err
        return req.result

    def _run(self) -> None:
        while True:
            with self._cond:
                # sleep until some request is READY to run (registrations
                # alone can't start a batch — there is nothing to encode
                # yet) or the batcher is closed and drained
                while True:
                    if any(r.ready for r in self._pending):
                        break
                    if self._closed and not self._pending:
                        return
                    self._cond.wait()
                deadline = time.monotonic() + self._wait
                seen = self._arrivals
                # the gap clock starts at THIS wake-up (the first ready
                # flip), not at the newest request's true arrival time:
                # under load, thread scheduling staggers a burst's
                # registrations by more than the gap, so an "already
                # quiet" clock would close a partial batch the instant its
                # first requests are ready. Clocking from the wake grants
                # stragglers one gap to
                # register; the cost is at most one idle_gap of close-wait
                # and only when every ready flip lands within the gap —
                # the per-batch close_ms in batch_log measures it
                last_arrival = time.monotonic()
                last_nready = 0
                while not self._closed:
                    now = time.monotonic()
                    if self._arrivals > seen:  # new registration: the
                        seen = self._arrivals  # burst is still arriving
                        last_arrival = now
                    # caps count STREAMS (the documented unit) —
                    # len(r.wins) would count device rows, quartering the
                    # effective cap under TTA
                    n_ready = sum(r.n_streams for r in self._pending
                                  if r.ready)
                    n_total = sum(r.n_streams for r in self._pending)
                    if n_ready > last_nready:
                        # a peer finished windowing: re-arm the cap. A
                        # burst's serialized windowing can outlast any
                        # fixed cap on a loaded host, and closing
                        # mid-burst costs a second padded forward; while
                        # flips keep landing the batch is making
                        # progress, so only a full max_wait with NO flip
                        # (a truly stalled straggler) fires the cap.
                        # Each request flips once, so the extension is
                        # bounded by the burst's own windowing span.
                        last_nready = n_ready
                        deadline = max(deadline, now + self._wait)
                    if n_ready >= self._max:
                        break  # a full fused call's worth is ready
                    if now >= deadline and n_ready:
                        break  # cap: run the ready ones, leave the
                        # still-windowing stragglers for the next batch
                    waits = [deadline - now]
                    if n_ready == n_total:
                        # nobody is mid-windowing: close after one quiet
                        # gap with no new arrival
                        quiet = now - last_arrival
                        if quiet >= self._gap:
                            break
                        waits.append(self._gap - quiet)
                    self._cond.wait(max(min(waits), 0.0))
                batch = [r for r in self._pending if r.ready]
                if not batch:  # closed while every pending request was
                    continue   # still windowing — wait for readiness
                self._pending = [r for r in self._pending if not r.ready]
            t_close = time.monotonic()
            try:
                with self._device_lock:
                    t_lock = time.monotonic()
                    out = self._pred.predict_windows(
                        np.concatenate([r.wins for r in batch]),
                        np.concatenate([r.valids for r in batch]),
                    )
            except Exception as err:  # fail every fused request loudly
                for r in batch:
                    r.err = err
                    r.done.set()
                continue
            t_dev = time.monotonic()
            # per-request distribution: one bad request (exotic top_k etc.)
            # must fail only itself, never kill the worker thread — a dead
            # worker would hang every queued and future submit forever
            ofs = 0
            for r in batch:
                n = r.n_streams
                try:
                    probs = out["probs"][ofs:ofs + n]
                    label = probs.argmax(-1)
                    k = min(int(r.top_k), probs.shape[-1])
                    r.result = {
                        "label": label,
                        "names": [self._pred.class_names[i] for i in label],
                        "probs": probs,
                        "topk": np.argsort(-probs, axis=-1)[:, :k],
                    }
                except Exception as err:
                    r.err = err
                finally:
                    ofs += n
                    r.done.set()
            # attribute the fused cycle: where did the time between the
            # first arrival and the last response go?
            last_ready = max(r.t_ready for r in batch)
            self.batch_log.append({
                "requests": len(batch),
                "streams": sum(r.n_streams for r in batch),
                # first arrival -> all windowed (GIL-staggered host phase)
                "window_ms": (last_ready - min(r.t_arr for r in batch))
                * 1e3,
                # all windowed -> batch close (gap-clock wait, if any)
                "close_ms": (t_close - last_ready) * 1e3,
                # close -> device lock held (contention with other routes)
                "lock_ms": (t_lock - t_close) * 1e3,
                # fused predict_windows (H2D + forward + D2H)
                "device_ms": (t_dev - t_lock) * 1e3,
                # slice-back + per-request top-k + wakeups
                "slice_ms": (time.monotonic() - t_dev) * 1e3,
            })


class _Request:
    __slots__ = ("wins", "valids", "top_k", "n_streams", "result", "err",
                 "done", "ready", "t_arr", "t_ready")

    def __init__(self, wins, valids, top_k, n_streams=None):
        self.wins, self.valids, self.top_k = wins, valids, top_k
        self.n_streams = len(wins) if n_streams is None else n_streams
        self.result = None
        self.err: Optional[Exception] = None
        self.done = threading.Event()
        self.ready = wins is not None  # flips True once windowing lands
        self.t_arr = time.monotonic()
        self.t_ready = self.t_arr if self.ready else None


class _Stats:
    """Serving counters + rolling latency window (GET /statz)."""

    WINDOW = 256

    def __init__(self):
        self._lock = threading.Lock()
        self.requests = 0
        self.streams = 0
        self.errors = 0
        self._lat_ms: list = []

    def record(self, n_streams: int, ms: float) -> None:
        with self._lock:
            self.requests += 1
            self.streams += n_streams
            self._lat_ms.append(ms)
            if len(self._lat_ms) > self.WINDOW:
                del self._lat_ms[: -self.WINDOW]

    def record_error(self) -> None:
        with self._lock:
            self.errors += 1

    def snapshot(self) -> dict:
        with self._lock:
            lat = sorted(self._lat_ms)
            out = {
                "predict_requests": self.requests,
                "streams": self.streams,
                "errors": self.errors,
            }
            if lat:
                out["latency_ms"] = {
                    "window": len(lat),
                    "p50": round(lat[len(lat) // 2], 3),
                    # nearest-rank p95
                    "p95": round(
                        lat[max(math.ceil(len(lat) * 0.95) - 1, 0)], 3),
                    "max": round(lat[-1], 3),
                }
            return out


class _InFlight:
    """Counts requests currently being handled so a graceful stop can
    wait for them: ThreadingHTTPServer's handler threads are daemons, so
    a bare shutdown() + process exit would kill them mid-request (client
    connection dropped, fused batcher results undelivered)."""

    def __init__(self):
        self._n = 0
        self._cond = threading.Condition()

    def __enter__(self):
        with self._cond:
            self._n += 1
        return self

    def __exit__(self, *exc):
        with self._cond:
            self._n -= 1
            if self._n == 0:
                self._cond.notify_all()
        return False

    def wait_idle(self, timeout: float) -> bool:
        """Block until no request is in flight; False on timeout."""
        deadline = time.monotonic() + timeout
        with self._cond:
            while self._n:
                left = deadline - time.monotonic()
                if left <= 0:
                    return False
                self._cond.wait(left)
            return True


class _SessionStore:
    """Live `serve.StreamSession`s keyed by opaque id.

    Sessions are per-sensor server-side ring buffers (the streaming
    deployment shape); they are evicted after ``ttl_s`` without a touch
    (a silent client must not leak buffers forever) and capped at
    ``max_sessions`` (each holds up to horizon x 16 bytes of events).
    The client-requested horizon is capped at ``max_horizon`` (default
    16x the predictor's natural horizon) — an unbounded horizon would
    let one client grow server memory without limit. Eviction is
    opportunistic — swept on every store access — so no background
    thread is needed.
    """

    def __init__(self, predictor, ttl_s: float = 600.0,
                 max_sessions: int = 64,
                 max_horizon: Optional[int] = None):
        self._pred = predictor
        self.ttl_s = float(ttl_s)
        self.max_sessions = int(max_sessions)
        self.max_horizon = int(
            max_horizon if max_horizon is not None
            else 16 * predictor.views * predictor.window
        )
        self._lock = threading.Lock()
        self._live: dict = {}  # id -> [StreamSession, last_touch]

    def _sweep(self, now: float) -> None:
        dead = [k for k, (_, t) in self._live.items()
                if now - t > self.ttl_s]
        for k in dead:
            del self._live[k]

    def create(self, horizon: Optional[int] = None) -> tuple:
        """-> (session_id, StreamSession); raises OverflowError at the cap
        (mapped to HTTP 429) and ValueError on a bad horizon (400)."""
        import secrets

        if horizon is not None and int(horizon) > self.max_horizon:
            raise ValueError(
                f"horizon {int(horizon)} exceeds the server cap "
                f"{self.max_horizon} (each buffered event costs 16 bytes "
                "server-side; raise --max_horizon to allow more)"
            )
        now = time.monotonic()
        with self._lock:
            self._sweep(now)
            if len(self._live) >= self.max_sessions:
                raise OverflowError(
                    f"session cap reached ({self.max_sessions}); close "
                    "sessions (DELETE /session/<id>) or raise "
                    "--max_sessions"
                )
            sess = StreamSession(self._pred, horizon=horizon)
            sid = secrets.token_hex(16)
            self._live[sid] = [sess, now]
            return sid, sess

    def get(self, sid: str):
        """Touch + return the session, or None (expired/unknown/closed)."""
        now = time.monotonic()
        with self._lock:
            self._sweep(now)
            entry = self._live.get(sid)
            if entry is None:
                return None
            entry[1] = now
            return entry[0]

    def close(self, sid: str) -> bool:
        with self._lock:
            return self._live.pop(sid, None) is not None

    def count(self) -> int:
        with self._lock:
            self._sweep(time.monotonic())
            return len(self._live)


class _Handler(BaseHTTPRequestHandler):
    # set per-server via make_server (class attributes on a subclass)
    predictor = None
    batcher: Optional[MicroBatcher] = None
    lock: threading.Lock = None
    stats: _Stats = None
    inflight: _InFlight = _InFlight()  # make_server installs a per-server one
    sessions: Optional[_SessionStore] = None  # make_server installs one
    max_body: int = DEFAULT_MAX_BODY
    quiet: bool = True
    auth_token: str = ""  # empty = open endpoint

    def _run_predict(self, streams, top_k: int):
        """The one device-phase entry every classifying route shares:
        through the micro-batcher when fusion is on, else serialized by
        the handler lock (the card runs one batch at a time)."""
        if self.batcher is not None:
            return self.batcher.submit(streams, top_k=top_k)
        with self.lock:
            return self.predictor.predict(streams, top_k=top_k)

    def _authorized(self) -> bool:
        if not self.auth_token:
            return True
        import hmac

        header = self.headers.get("Authorization", "")
        ok = hmac.compare_digest(header, f"Bearer {self.auth_token}")
        if not ok:
            self._error(401, "missing or invalid Authorization bearer token")
        return ok

    # -- plumbing ------------------------------------------------------------

    def log_message(self, fmt, *args):  # pragma: no cover - log control
        if not self.quiet:
            super().log_message(fmt, *args)

    def _send_json(self, code: int, obj) -> None:
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _error(self, code: int, message: str) -> None:
        self._send_json(code, {"error": message})

    def _read_body(self) -> Optional[bytes]:
        try:
            n = int(self.headers.get("Content-Length", "0"))
        except ValueError:
            self._error(400, "bad Content-Length")
            return None
        if n <= 0:
            self._error(400, "empty request body")
            return None
        if n > self.max_body:
            self._error(413, f"body {n} bytes exceeds limit {self.max_body}")
            return None
        return self.rfile.read(n)

    # -- request decoding ----------------------------------------------------

    def _decode_predict(self, body: bytes):
        """-> (streams, top_k, return_probs) or None (response already sent)."""
        from urllib.parse import parse_qs, urlparse

        q = parse_qs(urlparse(self.path).query)
        try:
            top_k = int(q.get("top_k", ["1"])[0])
        except (TypeError, ValueError):
            self._error(400, "top_k must be an integer")
            return None
        return_probs = (q.get("return_probs", ["0"])[0].strip().lower()
                        not in ("0", "false", ""))

        ctype = (self.headers.get("Content-Type") or "application/json")
        ctype = ctype.split(";")[0].strip().lower()
        if ctype == "application/x-npz":
            try:
                with np.load(io.BytesIO(body)) as z:
                    # archive insertion order IS the request order (np.savez
                    # writes arrays in call order; sorting would scramble
                    # arr_10 before arr_2 for positionally-saved streams)
                    streams = [np.asarray(z[k], dtype=np.float32)
                               for k in z.files]
            except Exception as err:
                self._error(400, f"bad npz body: {err}")
                return None
            return streams, top_k, return_probs

        try:
            req = json.loads(body)
        except json.JSONDecodeError as err:
            self._error(400, f"bad JSON body: {err}")
            return None
        if not isinstance(req, dict) or "streams" not in req:
            self._error(400, 'JSON body must be {"streams": [[[x,y,t,p],'
                             '...], ...], "top_k": 1}')
            return None
        try:
            streams = [np.asarray(s, dtype=np.float32)
                       for s in req["streams"]]
        except (TypeError, ValueError) as err:
            self._error(400, f"streams must be numeric [n, 4] arrays: {err}")
            return None
        try:
            top_k = int(req.get("top_k", top_k))
        except (TypeError, ValueError):
            self._error(400, "top_k must be an integer")
            return None
        return_probs = bool(req.get("return_probs", return_probs))
        return streams, top_k, return_probs

    # -- routes ----------------------------------------------------------------

    def do_GET(self):
        from urllib.parse import urlparse

        if not self._authorized():
            return
        route = urlparse(self.path).path
        if route == "/healthz":
            p = self.predictor
            # an ExportedPredictor carries no model, only its bundle's meta
            meta = getattr(p, "meta", None)
            self._send_json(200, {
                "status": "ok",
                "model": meta["model"] if meta else p._cfg.model,
                "arch": meta["arch"] if meta else p._cfg.clip.name,
                "n_classes": len(p.class_names),
                "batch_size": p.batch_size,
            })
        elif route == "/classes":
            self._send_json(200, {"classes": self.predictor.class_names})
        elif route == "/statz":
            snap = self.stats.snapshot()
            if self.sessions is not None:
                snap["sessions"] = self.sessions.count()
            self._send_json(200, snap)
        elif route.startswith("/session/"):
            parts = route.strip("/").split("/")
            sess = (self.sessions.get(parts[1])
                    if len(parts) == 2 else None)
            if sess is None:
                self._error(404, "unknown or expired session")
            else:
                self._send_json(200, {"n_events": sess.n_events,
                                      "horizon": sess.horizon})
        else:
            self._error(404, f"no route {route} (GET /healthz, GET /classes, "
                             "GET /statz, GET /session/<id>, POST /predict)")

    def do_DELETE(self):
        from urllib.parse import urlparse

        if not self._authorized():
            return
        parts = urlparse(self.path).path.strip("/").split("/")
        if len(parts) == 2 and parts[0] == "session":
            if self.sessions.close(parts[1]):
                self._send_json(200, {"closed": True})
            else:
                self._error(404, "unknown or expired session")
        else:
            self._error(404, "DELETE supports only /session/<id>")

    def do_POST(self):
        # counted so server.drain() can wait for in-flight predicts (GETs
        # are instant and stateless — losing one at exit is harmless)
        with self.inflight:
            self._do_post()

    def _do_post(self):
        from urllib.parse import urlparse

        if not self._authorized():
            return
        route = urlparse(self.path).path
        if route == "/embed":
            self._do_embed()
            return
        if route == "/set_classes":
            self._do_set_classes()
            return
        if route == "/session" or route.startswith("/session/"):
            self._do_session_post(route)
            return
        if route != "/predict":
            self._error(404, f"no route {route} (POST /predict, "
                             "POST /embed, POST /set_classes, "
                             "POST /session[...])")
            return
        body = self._read_body()
        if body is None:
            return
        decoded = self._decode_predict(body)
        if decoded is None:
            return
        streams, top_k, return_probs = decoded
        t0 = time.monotonic()
        try:
            # fused into one device batch with concurrent requests when
            # micro-batching is on (host half on this handler thread)
            out = self._run_predict(streams, top_k)
        except ValueError as err:
            # Predictor prefixes the offending index ("event_streams[i]: ...")
            self.stats.record_error()
            self._error(400, str(err))
            return
        except Exception as err:  # device/runtime failure: JSON 500, not a
            self.stats.record_error()
            self._error(500, f"{type(err).__name__}: {err}")  # dropped conn
            return
        self.stats.record(len(streams), (time.monotonic() - t0) * 1e3)
        resp = {
            "label": out["label"].tolist(),
            "names": out["names"],
            "topk": out["topk"].tolist(),
        }
        if return_probs:
            resp["probs"] = out["probs"].tolist()
        self._send_json(200, resp)

    # -- streaming sessions ----------------------------------------------------

    def _read_optional_json(self):
        """Body -> dict; an absent/empty body is {} (session routes take
        all-optional parameters). None = response already sent."""
        try:
            n = int(self.headers.get("Content-Length", "0"))
        except ValueError:
            self._error(400, "bad Content-Length")
            return None
        if n <= 0:
            return {}
        if n > self.max_body:
            self._error(413, f"body {n} bytes exceeds limit {self.max_body}")
            return None
        try:
            req = json.loads(self.rfile.read(n))
            assert isinstance(req, dict)
            return req
        except Exception as err:
            self._error(400, f"bad JSON body: {err}")
            return None

    def _decode_events(self, body: bytes):
        """One [n, 4] chunk for /session/<id>/events: JSON
        {"events": [[x,y,t,p], ...]} or an application/x-npz archive with
        exactly one array. -> (events, extras-dict) or None."""
        ctype = (self.headers.get("Content-Type") or "application/json")
        ctype = ctype.split(";")[0].strip().lower()
        if ctype == "application/x-npz":
            try:
                with np.load(io.BytesIO(body)) as z:
                    if len(z.files) != 1:
                        raise ValueError(
                            f"expected exactly one array, got {len(z.files)}"
                        )
                    events = np.asarray(z[z.files[0]], dtype=np.float32)
            except Exception as err:
                self._error(400, f"bad npz body: {err}")
                return None
            return events, {}
        try:
            req = json.loads(body)
            assert isinstance(req, dict) and "events" in req
        except Exception:
            self._error(400, 'JSON body must be {"events": [[x,y,t,p], '
                             '...], "predict": false, "top_k": 1}')
            return None
        try:
            events = np.asarray(req["events"], dtype=np.float32)
        except (TypeError, ValueError) as err:
            self._error(400, f"events must be a numeric [n, 4] array: {err}")
            return None
        return events, req

    def _session_rolling(self, sess, top_k: int):
        """Rolling prediction dict over a session's buffer. Delegates to
        serve.StreamSession.predict with the shared _run_predict injected
        as the device entry, so (a) the device phase fuses/serializes
        exactly like /predict and (b) the response assembly lives in ONE
        place (serve.py) instead of drifting here. Raises ValueError on
        an empty buffer and the device error otherwise."""
        t0 = time.monotonic()
        out = sess.predict(top_k=top_k, predict_fn=self._run_predict)
        self.stats.record(1, (time.monotonic() - t0) * 1e3)
        out["probs"] = np.asarray(out["probs"]).tolist()
        out["topk"] = np.asarray(out["topk"]).tolist()
        return out

    def _do_session_post(self, route: str):
        """POST /session (open), /session/<id>/events (append a chunk;
        "predict": true piggybacks a rolling prediction on the append),
        /session/<id>/predict (prediction only)."""
        parts = route.strip("/").split("/")
        if parts == ["session"]:
            req = self._read_optional_json()
            if req is None:
                return
            try:
                horizon = req.get("horizon")
                sid, sess = self.sessions.create(
                    horizon=int(horizon) if horizon is not None else None
                )
            except OverflowError as err:
                self._error(429, str(err))
                return
            except (TypeError, ValueError) as err:
                self._error(400, str(err))
                return
            self._send_json(200, {"session_id": sid,
                                  "horizon": sess.horizon})
            return

        if len(parts) != 3 or parts[2] not in ("events", "predict"):
            self._error(404, f"no route /{'/'.join(parts)} (POST /session, "
                             "POST /session/<id>/events, "
                             "POST /session/<id>/predict)")
            return
        sess = self.sessions.get(parts[1])
        if sess is None:
            self._error(404, "unknown or expired session (sessions expire "
                             f"after {self.sessions.ttl_s:.0f}s idle)")
            return

        if parts[2] == "predict":
            req = self._read_optional_json()
            if req is None:
                return
            try:  # parse OUTSIDE the predict try: a bad top_k is a 400,
                top_k = int(req.get("top_k", 1))  # not an empty-buffer 409
            except (TypeError, ValueError):
                self._error(400, "top_k must be an integer")
                return
            try:
                resp = self._session_rolling(sess, top_k)
            except ValueError as err:  # empty session buffer
                self._error(409, str(err))
                return
            except Exception as err:
                self.stats.record_error()
                self._error(500, f"{type(err).__name__}: {err}")
                return
            self._send_json(200, resp)
            return

        body = self._read_body()
        if body is None:
            return
        decoded = self._decode_events(body)
        if decoded is None:
            return
        events, req = decoded
        from urllib.parse import parse_qs, urlparse

        q = parse_qs(urlparse(self.path).query)
        want_pred = bool(req.get("predict")) or (
            q.get("predict", ["0"])[0].strip().lower()
            not in ("0", "false", ""))
        try:
            top_k = int(req.get("top_k", q.get("top_k", ["1"])[0]))
        except (TypeError, ValueError):
            self._error(400, "top_k must be an integer")
            return
        try:
            n = sess.append(events)
        except ValueError as err:
            self._error(400, str(err))
            return
        resp = {"n_events": n, "horizon": sess.horizon}
        if want_pred:
            try:
                resp.update(self._session_rolling(sess, top_k))
            except Exception as err:
                # the append above already took effect — report THAT as
                # success with an in-band prediction error, so a client
                # retrying an error response cannot double-append
                self.stats.record_error()
                resp["predict_error"] = f"{type(err).__name__}: {err}"
        self._send_json(200, resp)

    def _do_embed(self):
        """POST /embed: same request bodies as /predict (top_k ignored);
        responds {"embeddings": [[...], ...]} — one L2-normalized CLIP
        feature per stream. Requires the server to run with --embed.
        Embeds bypass the micro-batcher's FUSION (indexing jobs batch
        client-side) but serialize against its device phase through the
        shared lock — the card runs one batch at a time."""
        if not getattr(self.predictor, "_embed", False):
            self._error(
                400, "embeddings are not enabled on this server "
                     "(start it with --embed)")
            return
        body = self._read_body()
        if body is None:
            return
        decoded = self._decode_predict(body)
        if decoded is None:
            return
        streams, _, _ = decoded
        t0 = time.monotonic()
        try:
            with self.lock:
                feats = self.predictor.embed(streams)
        except ValueError as err:
            self.stats.record_error()
            self._error(400, str(err))
            return
        except Exception as err:
            self.stats.record_error()
            self._error(500, f"{type(err).__name__}: {err}")
            return
        self.stats.record(len(streams), (time.monotonic() - t0) * 1e3)
        self._send_json(200, {"embeddings": feats.tolist()})

    def _do_set_classes(self):
        """POST /set_classes {"classes": [...]}: swap the served label set
        at runtime (CLIP open vocabulary; Predictor.set_classes). Serialized
        against non-fused predicts via the handler lock; rejected when
        micro-batching is on (fused batches could straddle the swap and
        name old-feature rows with new labels)."""
        if self.batcher is not None:
            self._error(
                409, "class swapping is unavailable with --microbatch_ms "
                     "(a fused batch could straddle the swap); restart the "
                     "server or disable micro-batching")
            return
        body = self._read_body()
        if body is None:
            return
        try:
            req = json.loads(body)
            names = req["classes"]
            assert isinstance(names, list) and names
            assert all(isinstance(n, str) for n in names)
        except Exception:
            self._error(400, 'body must be {"classes": ["name", ...]} '
                             "(non-empty list of strings)")
            return
        try:
            with self.lock:
                self.predictor.set_classes(names)
        except ValueError as err:  # e.g. prompt-tuned checkpoint
            self.stats.record_error()
            self._error(400, str(err))
            return
        except Exception as err:
            self.stats.record_error()
            self._error(500, f"{type(err).__name__}: {err}")
            return
        self._send_json(200, {"classes": self.predictor.class_names})


def make_server(predictor, host: str = "127.0.0.1", port: int = 8000,
                max_body: int = DEFAULT_MAX_BODY,
                quiet: bool = True,
                microbatch_ms: float = 0.0,
                microbatch_idle_ms: Optional[float] = None,
                auth_token: str = "",
                session_ttl_s: float = 600.0,
                max_sessions: int = 64,
                max_horizon: Optional[int] = None) -> ThreadingHTTPServer:
    """Bind an HTTP server around a built Predictor (port 0 = ephemeral).

    microbatch_ms > 0 fuses concurrent requests into one device batch
    (MicroBatcher); the batcher is exposed as ``server.batcher``. A
    non-empty auth_token requires ``Authorization: Bearer <token>`` on
    every route (401 otherwise; constant-time comparison).

    ``server.shutdown()`` (also exposed as ``server.drain(timeout)``) is
    a graceful drain: stop accepting, wait — bounded — for in-flight
    predict handlers, then close the batcher. Handler threads are
    daemons, so exiting without the wait would sever clients mid-request.
    """
    # ONE device lock: the fused batcher's device phase and every
    # non-fused device route (/predict without fusion, /embed) serialize
    # through it — the card runs one batch at a time
    lock = threading.Lock()
    batcher = (MicroBatcher(predictor, microbatch_ms,
                            idle_gap_ms=microbatch_idle_ms,
                            device_lock=lock)
               if microbatch_ms > 0 else None)
    inflight = _InFlight()
    sessions = _SessionStore(predictor, ttl_s=session_ttl_s,
                             max_sessions=max_sessions,
                             max_horizon=max_horizon)
    handler = type("Handler", (_Handler,), {
        "predictor": predictor,
        "batcher": batcher,
        "lock": lock,
        "stats": _Stats(),
        "max_body": max_body,
        "quiet": quiet,
        "auth_token": auth_token,
        "inflight": inflight,
        "sessions": sessions,
    })
    server = ThreadingHTTPServer((host, port), handler)
    server.batcher = batcher
    server.inflight = inflight
    server.sessions = sessions
    inner = server.shutdown

    def drain(timeout: float = 30.0) -> bool:
        """Stop accepting, wait for in-flight predicts, close the
        batcher. Idempotent and safe to call concurrently; returns False
        if the timeout expired with requests still running. Must not be
        called from a handler thread (it would wait on itself)."""
        inner()
        # the accept loop has stopped, but a just-accepted connection's
        # handler thread may not have entered the counter yet
        time.sleep(0.05)
        ok = inflight.wait_idle(timeout)
        if batcher is not None:
            batcher.close()
        return ok

    server.drain = drain
    server.shutdown = drain  # every stop is a graceful drain
    return server


def _warm_up(predictor) -> None:
    """Run every program a request can select BEFORE accepting traffic, so
    allocator growth and library initialization never land on a request.
    Predictor.warm_up crafts one device chunk per packed bucket — exact
    coverage for every batch_size/tta combination."""
    predictor.warm_up(log=lambda msg: print(msg, flush=True))


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(
        description="EventCLIP HTTP serving endpoint (PyTorch, on the card)")
    ap.add_argument("--params", default="",
                    help="experiment config (same file the CLIs take)")
    ap.add_argument("--from_export", default="",
                    help="serve a frozen bundle written by `python -m "
                    "eventclip_tpu_torch.export` instead of building the "
                    "model — "
                    "no config/weights needed on this host (model flags "
                    "like --weight/--int8/--tta are baked into the bundle "
                    "and rejected here)")
    ap.add_argument("--weight", default="",
                    help="checkpoint (.npz or reference .pth); required for "
                    "trainable models")
    ap.add_argument("--classes", default="",
                    help="text file with one class name per line")
    ap.add_argument("--data_root", default="",
                    help="dataset root to derive class names from "
                         "(alternative to --classes)")
    ap.add_argument("--clip_ckpt", default="",
                    help="OpenAI CLIP .pt checkpoint (or converted .npz)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--batch_size", type=int, default=32,
                    help="device batch; requests are chunked/padded to it")
    ap.add_argument("--int8", action="store_true",
                    help="W8A8 int8 tower")
    ap.add_argument("--int8_calib", default="",
                    help="with --int8: glob of .npy raw event dumps "
                    "([n, 4] x/y/t/p) to calibrate STATIC activation "
                    "scales on (out-of-range activations clip — cover "
                    "representative traffic)")
    ap.add_argument("--prune_tokens", type=int, default=0,
                    help="keep K highest-variance ViT tokens (stacks w/ int8)")
    ap.add_argument("--data_parallel", action="store_true",
                    help="replicate the model on every visible card and "
                    "split each batch over them")
    ap.add_argument("--tta", action="store_true",
                    help="4-variant event TTA (4x compute, averaged probs)")
    ap.add_argument("--embed", action="store_true",
                    help="enable POST /embed (one L2-normalized CLIP "
                         "feature per stream; one extra program at warm-up)")
    ap.add_argument("--smoke", action="store_true",
                    help="random CLIP weights (pipeline demo, no accuracy)")
    ap.add_argument("--cpu", action="store_true",
                    help="serve on the CPU (debug); default: the card")
    ap.add_argument("--microbatch_ms", type=float, default=0.0,
                    help="fuse concurrent requests into one device batch, "
                         "collecting adaptively up to this hard cap "
                         "(0 = off; 10-100 ms is a good start under "
                         "concurrent single-stream load)")
    ap.add_argument("--microbatch_idle_ms", type=float, default=None,
                    help="close a collecting batch after this long with no "
                         "new arrival (default: microbatch_ms / 4); a lone "
                         "request waits only this, not the full cap")
    ap.add_argument("--max_body_mb", type=int, default=512)
    ap.add_argument("--session_ttl", type=float, default=600.0,
                    help="evict a streaming session after this many idle "
                         "seconds (POST /session opens one)")
    ap.add_argument("--max_sessions", type=int, default=64,
                    help="cap on concurrently open streaming sessions "
                         "(429 past it)")
    ap.add_argument("--max_horizon", type=int, default=None,
                    help="cap on a session's client-requested event "
                         "horizon (default 16x the natural horizon; each "
                         "buffered event costs 16 bytes server-side)")
    ap.add_argument("--auth_token", default="",
                    help="require 'Authorization: Bearer <token>' on every "
                         "route (default: open endpoint). Prefer "
                         "EVENTCLIP_AUTH_TOKEN over the flag — argv is "
                         "visible in process listings.")
    args = ap.parse_args(argv)
    auth_token = args.auth_token or os.environ.get(
        "EVENTCLIP_AUTH_TOKEN", "")

    device = "cpu" if args.cpu else "cuda"
    if bool(args.params) == bool(args.from_export):
        ap.error("pass exactly one of --params or --from_export")
    if args.from_export:
        # every model decision is frozen inside the bundle; a flag that
        # silently did nothing would be a misconfiguration time bomb
        baked = {"--weight": args.weight, "--classes": args.classes,
                 "--data_root": args.data_root, "--clip_ckpt": args.clip_ckpt,
                 "--int8": args.int8, "--int8_calib": args.int8_calib,
                 "--prune_tokens": args.prune_tokens,
                 "--data_parallel": args.data_parallel, "--tta": args.tta,
                 "--embed": args.embed, "--smoke": args.smoke}
        offending = [k for k, v in baked.items() if v]
        if args.batch_size != ap.get_default("batch_size"):
            offending.append("--batch_size")
        if offending:
            ap.error(f"{' '.join(offending)}: baked into the bundle at "
                     "export time — re-export to change them")
        from .export import ExportedPredictor

        predictor = ExportedPredictor(args.from_export, device=device)
        model_desc = f"exported bundle {args.from_export}"
        names = predictor.class_names
    else:
        params = load_params(args.params)
        names = resolve_class_names(params, args.classes, args.data_root)
        calib_streams = None
        if args.int8_calib:
            import glob as globlib

            files = sorted(globlib.glob(args.int8_calib))
            if not files:
                ap.error(f"--int8_calib matched no files: {args.int8_calib}")
            calib_streams = [np.load(f) for f in files]
        predictor = Predictor(
            params, names, weight=args.weight,
            clip_ckpt=args.clip_ckpt or None, smoke=args.smoke,
            int8=args.int8, int8_calib_streams=calib_streams,
            prune_tokens=args.prune_tokens,
            batch_size=args.batch_size, data_parallel=args.data_parallel,
            tta=args.tta, embed=args.embed, device=device,
        )
        model_desc = f"{params.model} ({params.clip_dict['arch']})"
    _warm_up(predictor)

    server = make_server(predictor, args.host, args.port,
                         max_body=args.max_body_mb * 1024 * 1024,
                         quiet=False, microbatch_ms=args.microbatch_ms,
                         microbatch_idle_ms=args.microbatch_idle_ms,
                         auth_token=auth_token,
                         session_ttl_s=args.session_ttl,
                         max_sessions=args.max_sessions,
                         max_horizon=args.max_horizon)
    print(f"serving {model_desc} on "
          f"http://{args.host}:{server.server_address[1]}  "
          f"[{len(names)} classes, batch_size={predictor.batch_size}]",
          flush=True)

    # graceful drain on SIGTERM (the signal schedulers/orchestrators send):
    # stop accepting, finish in-flight requests, close the batcher, exit 0.
    # The drain must not run on the signal frame (it joins serve_forever's
    # own thread), so hand it to a helper thread; serve_forever returns as
    # soon as the accept loop stops, and the main thread then runs the
    # (idempotent, concurrency-safe) drain to completion itself — without
    # this wait, interpreter exit would kill the daemon handler threads
    # mid-request.
    import signal

    def _term(signum, frame):  # pragma: no cover - exercised via e2e
        threading.Thread(target=server.drain, daemon=True).start()

    signal.signal(signal.SIGTERM, _term)
    try:
        server.serve_forever()
    except KeyboardInterrupt:  # pragma: no cover - interactive exit
        pass
    drained = server.drain()
    server.server_close()
    print("server stopped" + ("" if drained else " (drain timed out)"),
          flush=True)


if __name__ == "__main__":
    main()
