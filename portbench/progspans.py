"""The program's own spans, as the per-layer metrics read them.

`eventclip_tpu_torch.utils.spans` records a span at every stage boundary
of `serve.Predictor`'s serving path while a `torch.profiler` session is
active, stamped in Unix-epoch ns: the clock of the profiler's events, so
`ns * 1e-9` is a time on the clock of `devtrace.Trace`. A traced run has
the profiler on for exactly its window, so what the recorder holds after
the window is the window's spans. A program that records no spans (one
without the recorder) gives an empty list, and each reader then None; so
does a full ring, which may have dropped the window's oldest spans.
"""

from __future__ import annotations

import bisect
from typing import Dict, Iterable, List, Optional, Tuple

from portbench import devtrace


def recorded() -> list:
    """The spans the program recorded in this process, oldest first;
    none where the ring is full (spans may have been dropped)."""
    try:
        from eventclip_tpu_torch.utils import spans
    except ImportError:
        return []
    recs = spans.records()
    return [] if len(recs) >= spans.CAPACITY else recs


def ms_a_request(ctx, names: Iterable[str]) -> Optional[float]:
    """The summed duration of the spans called `names`, in ms a request
    (over `len(ctx.requests)`, as `host_window_ms.batch` divides)."""
    names = set(names)
    picked = [r for r in recorded() if r.name in names]
    if not picked or not ctx.requests:
        return None
    return 1e-6 * sum(r.end_ns - r.start_ns for r in picked) \
        / len(ctx.requests)


class Idle:
    """The device's idle stretches (`Trace.idle`: disjoint, sorted), and
    how much of them lies within any [a, b]."""

    def __init__(self, gaps: List[Tuple[float, float]]):
        self.starts = [a for a, _ in gaps]
        self.ends = [b for _, b in gaps]
        self.before = [0.0]  # idle time of the gaps before gap i
        for a, b in gaps:
            self.before.append(self.before[-1] + (b - a))
        self.total = self.before[-1]

    def upto(self, t: float) -> float:
        """Idle time before t."""
        i = bisect.bisect_right(self.starts, t)
        if i == 0:
            return 0.0
        return self.before[i - 1] + min(t, self.ends[i - 1]) \
            - self.starts[i - 1]

    def within(self, a: float, b: float) -> float:
        return self.upto(b) - self.upto(a) if b > a else 0.0


def seconds(r) -> Tuple[float, float]:
    return r.start_ns * 1e-9, r.end_ns * 1e-9


def idle_outside(intervals, idle: Idle, lo: float, hi: float) -> float:
    """Idle time in [lo, hi] that none of `intervals` covers."""
    return sum(idle.within(a, b)
               for a, b in devtrace.gaps(intervals, lo, hi))


def idle_outside_roots(recs, idle: Idle, lo: float, hi: float) -> float:
    """Idle time in [lo, hi] under no root span (one without a parent)."""
    return idle_outside([seconds(r) for r in recs if r.parent is None],
                        idle, lo, hi)


def idle_by_stage(recs, idle: Idle) -> Dict[str, float]:
    """Idle time by the innermost span open over it: each span's interval
    less those of its children, summed by name."""
    kids: Dict[int, List[Tuple[float, float]]] = {}
    for r in recs:
        if r.parent is not None:
            kids.setdefault(r.parent, []).append(seconds(r))
    out: Dict[str, float] = {}
    for r in recs:
        own = idle_outside(kids.get(r.id, []), idle, *seconds(r))
        if own > 0:
            out[r.name] = out.get(r.name, 0.0) + own
    return out
