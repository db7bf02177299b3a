"""Spans: named host intervals of the program, on the profiler's clock.

An operator reads them beside a `torch.profiler` trace of the same
process: each span is stamped in Unix-epoch nanoseconds, the clock of the
profiler's events (`start_ns()`), so a stretch where the card sat idle
can be put down to the host stage that was running then.

    from eventclip_tpu_torch.utils import spans

    with spans.span("serve.pack") as s:
        batch = pack_view_batch(...)
        if s:
            s.count(valid_views=..., packed_views=...)

`span` records while a `torch.profiler` session is active in the process,
or after `enable()` (until `disable()`). Otherwise it costs two attribute
tests, reads no clock and returns a shared no-op span (false in a
boolean test, so counts that cost work can be skipped: `if s: ...`).

Each recorded `Span` holds its name, start and end (epoch ns), its own
id, its parent's id (the innermost span open on the same thread, else
None), the id of its root (the outermost one; a root's is its own), and
integer counts given at either boundary. Parents cross threads only
through `carry`: a job handed to a worker thread opens its spans under
the span that was open where it was handed over, so one request stays one
tree; spans opened on two handler threads at once form two. Both ends
are read from `time.time_ns()`. The newest `CAPACITY` spans stay in
memory (`records()`, `clear()`): a reader that finds the ring full cannot
tell whether older spans were dropped. Nothing is written to a file. No
`record_function` range is opened: a range that encloses launches would
get a device row of its own in the profiler's trace.
"""

from __future__ import annotations

import collections
import itertools
import threading
from time import time_ns
from typing import Dict, List, NamedTuple, Optional

import torch.autograd.profiler as _profiler

CAPACITY = 1 << 17

_enabled = False
_ring: collections.deque = collections.deque(maxlen=CAPACITY)
_ids = itertools.count(1)
_local = threading.local()


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: Optional[int]
    root: int
    counts: Dict[str, int]


class _Open:
    """A span while it is open (the context manager `span` returns)."""

    __slots__ = ("name", "counts", "id", "parent", "root", "start",
                 "stack")

    def __init__(self, name: str, counts: Dict[str, int]):
        self.name = name
        self.counts = counts

    def count(self, **counts: int) -> None:
        self.counts.update(counts)

    def __enter__(self) -> "_Open":
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.id = next(_ids)
        if stack:
            self.parent, self.root = stack[-1].id, stack[-1].root
        else:
            self.parent, self.root = None, self.id
        stack.append(self)
        self.stack = stack
        self.start = time_ns()
        return self

    def __exit__(self, *exc) -> bool:
        end = time_ns()
        self.stack.pop()
        _ring.append(Span(self.name, self.start, end, self.id, self.parent,
                          self.root, self.counts))
        return False


class _Off:
    """The span `span` returns while nothing records: does nothing."""

    __slots__ = ()

    def __bool__(self) -> bool:
        return False

    def count(self, **counts: int) -> None:
        pass

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, *exc) -> bool:
        return False


_OFF = _Off()


def span(name: str, **counts: int):
    """A context manager that records `name` over its body, with `counts`
    (more may be added inside through `.count(...)`)."""
    if _enabled or _profiler._is_profiler_enabled:
        return _Open(name, counts)
    return _OFF


def carry(fn):
    """`fn`, to be run on another thread with the innermost span open on
    this one as the parent of the spans it opens there (the caller keeps
    that span open until `fn` returns); `fn` itself when no span is open
    here, as while nothing records."""
    stack = getattr(_local, "stack", None)
    if not stack:
        return fn
    parent = stack[-1]

    def under_parent(*args, **kwargs):
        own = getattr(_local, "stack", None)
        if own is None:
            own = _local.stack = []
        own.append(parent)
        try:
            return fn(*args, **kwargs)
        finally:
            own.pop()

    return under_parent


def enable() -> None:
    """Record from now on, with or without a profiler session."""
    global _enabled
    _enabled = True


def disable() -> None:
    """Record again only while a profiler session is active."""
    global _enabled
    _enabled = False


def records() -> List[Span]:
    """The recorded spans, oldest first (the newest `CAPACITY`)."""
    return list(_ring)


def clear() -> None:
    _ring.clear()
