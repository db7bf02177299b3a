"""Reference host windowing, in NumPy: a raw `[n, 4]` x/y/t/p stream to
the event windows a classifier sees.

The semantics are EventCLIP's (`datasets/event2img.py`, `datasets/vis.py`,
`datasets/utils.py` of Wuziyi616/EventCLIP), as the served path states
them:

- polarity given as 0/1 is mapped to -1/+1;
- view subsampling is seeded from the stream's content (crc32 of the
  float32 bytes), so a stream's views do not depend on its place in a
  request;
- timestamps start at 0 and the events' bounding box is centred in the
  sensor frame by `((max + min + 1) - size) // 2`;
- the stream is cut into windows of exactly `window` events, plus a tail
  window of the last `window` events where the remainder is more than half
  a window; a stream shorter than a window is one window;
- more windows than `views` slots: a random subset in random order (a
  permutation's head); fewer: the windows in order, then empty slots.
"""

from __future__ import annotations

import zlib
from typing import List, Tuple

import numpy as np


def event_count_spans(n: int, window: int) -> List[Tuple[int, int]]:
    if n < window:
        return [(0, n)]
    q = -(-n // window)
    spans = [(k * window, (k + 1) * window) for k in range(q - 1)]
    if 2 * (n - (q - 1) * window) > window:
        spans.append((n - window, n))
    return spans


def centred(events: np.ndarray, height: int, width: int) -> np.ndarray:
    ev = events.copy()
    ev[:, 2] -= ev[:, 2].min()
    ev[:, 0] -= ((ev[:, 0].max() + ev[:, 0].min() + 1.0) - width) // 2.0
    ev[:, 1] -= ((ev[:, 1].max() + ev[:, 1].min() + 1.0) - height) // 2.0
    return ev


def stream_windows(events: np.ndarray, height: int, width: int,
                   window: int, views: int):
    """-> (list of [m, 3] float32 x/y/p arrays, one per view, in slot
    order; the number of slots, `views`)."""
    ev = np.array(events, dtype=np.float32, copy=True)
    if ev[:, 3].min() >= -0.5:
        ev[:, 3] = np.where(ev[:, 3] <= 0.5, -1.0, 1.0)
    rng = np.random.default_rng(zlib.crc32(np.ascontiguousarray(ev)
                                           .tobytes()))
    ev = centred(ev, height, width)
    spans = event_count_spans(len(ev), window)
    if len(spans) > views:
        spans = [spans[i] for i in rng.permutation(len(spans))[:views]]
    return [ev[a:b][:, (0, 1, 3)] for a, b in spans]
