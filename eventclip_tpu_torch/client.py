"""Client for the eventclip_tpu_torch HTTP serving endpoint (server.py).

The port's own copy of eventclip_tpu/client.py (that module loads JAX
through its package): stdlib-only, it mirrors the server's request
encodings so callers never hand-roll them. Predictions travel as
``application/x-npz`` bodies (one array per stream, archive order = request
order), far smaller on the wire than JSON for real sensor dumps.

Example:
    from eventclip_tpu_torch.client import ServingClient
    c = ServingClient("http://gpu-host:8000")
    c.health()                      # {'status': 'ok', ...}
    out = c.predict(event_arrays)   # {'label', 'names', 'probs'?, 'topk'}
"""

from __future__ import annotations

import io
import json
import urllib.error
import urllib.request
from typing import Any, Dict, List, Sequence

import numpy as np


class ServingError(RuntimeError):
    """An HTTP error from the serving endpoint, with its decoded message."""

    def __init__(self, status: int, message: str):
        super().__init__(f"HTTP {status}: {message}")
        self.status = status
        self.message = message


class ServingClient:
    def __init__(self, base_url: str, timeout: float = 120.0,
                 auth_token: str = ""):
        self.base_url = base_url.rstrip("/")
        self.timeout = timeout
        self.auth_token = auth_token

    # -- plumbing --------------------------------------------------------------

    def _request(self, path: str, data: bytes = None,
                 ctype: str = "", method: str = "") -> Dict[str, Any]:
        headers = {"Content-Type": ctype} if ctype else {}
        if self.auth_token:
            headers["Authorization"] = f"Bearer {self.auth_token}"
        req = urllib.request.Request(
            self.base_url + path, data=data, headers=headers,
            method=method or ("POST" if data is not None else "GET"),
        )
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as r:
                return json.loads(r.read())
        except urllib.error.HTTPError as err:
            try:
                message = json.loads(err.read()).get("error", str(err))
            except Exception:
                message = str(err)
            raise ServingError(err.code, message) from None

    # -- API -------------------------------------------------------------------

    def health(self) -> Dict[str, Any]:
        return self._request("/healthz")

    def classes(self) -> List[str]:
        return self._request("/classes")["classes"]

    def stats(self) -> Dict[str, Any]:
        """Serving counters + rolling latency percentiles (GET /statz)."""
        return self._request("/statz")

    def predict(self, event_streams: Sequence[np.ndarray], top_k: int = 1,
                return_probs: bool = False) -> Dict[str, Any]:
        """Classify raw event streams ([n, 4] float x/y/t/p arrays).

        Returns {'label': [B] int array, 'names': [B] str list,
        'topk': [B, k] int array} (+ 'probs' [B, C] f32 when requested),
        rows aligned with the input order — the same contract as
        serve.Predictor.predict.
        """
        buf = io.BytesIO()
        np.savez(buf, *[np.asarray(s, dtype=np.float32)
                        for s in event_streams])
        q = f"?top_k={int(top_k)}&return_probs={1 if return_probs else 0}"
        resp = self._request("/predict" + q, data=buf.getvalue(),
                             ctype="application/x-npz")
        out = {
            "label": np.asarray(resp["label"], dtype=np.int64),
            "names": resp["names"],
            "topk": np.asarray(resp["topk"], dtype=np.int64),
        }
        if return_probs:
            out["probs"] = np.asarray(resp["probs"], dtype=np.float32)
        return out

    def embed(self, event_streams: Sequence[np.ndarray]) -> np.ndarray:
        """Raw event streams -> [B, C] L2-normalized CLIP features
        (requires the server to run with --embed); same wire encoding
        as predict()."""
        buf = io.BytesIO()
        np.savez(buf, *[np.asarray(s, dtype=np.float32)
                        for s in event_streams])
        resp = self._request("/embed", data=buf.getvalue(),
                             ctype="application/x-npz")
        return np.asarray(resp["embeddings"], dtype=np.float32)

    def set_classes(self, class_names: Sequence[str]) -> List[str]:
        """Swap the served label set at runtime (open vocabulary; 409 when
        the server runs with --microbatch_ms). Returns the active list."""
        body = json.dumps({"classes": list(class_names)}).encode()
        resp = self._request("/set_classes", data=body,
                             ctype="application/json")
        return resp["classes"]

    def open_session(self, horizon: int = None) -> "StreamingSession":
        """Open a server-side streaming session (live sensor feed: append
        event chunks, poll rolling predictions). Usable as a context
        manager — closing deletes the server-side buffer."""
        body = (json.dumps({"horizon": int(horizon)}).encode()
                if horizon is not None else b"")
        resp = self._request("/session", data=body,
                             ctype="application/json")
        return StreamingSession(self, resp["session_id"], resp["horizon"])


class StreamingSession:
    """Handle to one server-side streaming session (ServingClient.open_session)."""

    def __init__(self, client: ServingClient, session_id: str, horizon: int):
        self._c = client
        self.session_id = session_id
        self.horizon = horizon

    def _path(self, suffix: str = "") -> str:
        return f"/session/{self.session_id}{suffix}"

    def append(self, events: np.ndarray, predict: bool = False,
               top_k: int = 1) -> Dict[str, Any]:
        """Append one [n, 4] chunk; with predict=True the response also
        carries the rolling prediction over the updated buffer."""
        buf = io.BytesIO()
        np.savez(buf, events=np.asarray(events, dtype=np.float32))
        q = f"?predict={1 if predict else 0}&top_k={int(top_k)}"
        return self._c._request(self._path("/events") + q,
                                data=buf.getvalue(),
                                ctype="application/x-npz")

    def predict(self, top_k: int = 1) -> Dict[str, Any]:
        """Rolling prediction over the buffered events (no append)."""
        body = json.dumps({"top_k": int(top_k)}).encode()
        return self._c._request(self._path("/predict"), data=body,
                                ctype="application/json")

    def info(self) -> Dict[str, Any]:
        return self._c._request(self._path())

    def close(self) -> None:
        self._c._request(self._path(), method="DELETE")

    def __enter__(self) -> "StreamingSession":
        return self

    def __exit__(self, *exc) -> None:
        try:
            self.close()
        except ServingError:  # already expired/closed
            pass
