"""Spans around the calls into the program, and the device trace's reduction.

`Spans` times each call on the host clock and, in a traced run, also
opens a `record_function` range of the same name, so the trace knows
what the host was doing. `reduce_trace` turns a finished
`torch.profiler` session into device intervals (kernels, copies, sets;
the ranges' own device rows left out), the device's busy time as the
union of those intervals, the idle gaps labelled by the innermost
harness range open on the host halfway through each, and the operations
that took most time. The method is chip_smoke.py's `profile_call`, with busy
time taken as a union instead of a sum.
"""

from __future__ import annotations

import collections
import contextlib
import time
from typing import Dict, List, Optional, Tuple

PREFIX = "portbench."


class Spans:
    def __init__(self, traced: bool = False):
        self.traced = traced
        self.times: Dict[str, List[float]] = collections.defaultdict(list)

    @contextlib.contextmanager
    def __call__(self, name: str):
        rf = contextlib.nullcontext()
        if self.traced:
            from torch.profiler import record_function

            rf = record_function(PREFIX + name)
        t0 = time.perf_counter()
        with rf:
            yield
        self.times[name].append(time.perf_counter() - t0)


def union_length(intervals: List[Tuple[float, float]]) -> float:
    """Length covered by the union of (start, end) intervals."""
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def gaps(intervals: List[Tuple[float, float]], lo: float,
         hi: float) -> List[Tuple[float, float]]:
    """The stretches of [lo, hi] that no interval covers."""
    out, at = [], lo
    for a, b in sorted(intervals):
        if a > at:
            out.append((at, min(a, hi)))
        at = max(at, b)
        if at >= hi:
            break
    if at < hi:
        out.append((at, hi))
    return [(a, b) for a, b in out if b > a]


class Trace:
    """A reduced trace: times in seconds on the trace's own clock."""

    def __init__(self, kernels, ranges, window):
        self.kernels: List[Tuple[str, float, float]] = kernels
        self.ranges: List[Tuple[str, float, float]] = ranges
        self.lo, self.hi = window
        inside = [(max(a, self.lo), min(a + d, self.hi))
                  for _, a, d in kernels if a + d > self.lo and a < self.hi]
        self.busy_s = union_length(inside)
        self.window_s = self.hi - self.lo
        self.idle = gaps(inside, self.lo, self.hi)

    def matching(self, names) -> List[Tuple[str, float, float]]:
        return [k for k in self.kernels if any(n in k[0] for n in names)]

    def label_at(self, t: float) -> str:
        """The innermost harness range open at trace time t."""
        best: Optional[Tuple[str, float, float]] = None
        for name, a, b in self.ranges:
            if a <= t < b and (best is None or a >= best[1]):
                best = (name, a, b)
        return best[0][len(PREFIX):] if best else "outside"

    def breakdown(self, top: int = 10) -> Dict[str, list]:
        by_name: Dict[str, float] = collections.Counter()
        for name, _, d in self.kernels:
            by_name[name] += d
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        longest = sorted(self.idle, key=lambda g: g[0] - g[1])[:top]
        return {"device_ops": [[n[:200], s] for n, s in ops],
                "idle_gaps": [[self.label_at((a + b) / 2), b - a]
                              for a, b in longest]}


def reduce_trace(prof) -> Trace:
    """A finished torch.profiler session -> Trace (device time read from
    CUPTI's kernel, copy and set records)."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    events = prof.profiler.kineto_results.events()
    ranges, kernels, window = [], [], None
    for e in events:
        name = e.name()
        if e.device_type() != cuda:
            if name.startswith(PREFIX):
                a = e.start_ns() * 1e-9
                ranges.append((name, a, a + e.duration_ns() * 1e-9))
                if name == PREFIX + "window":
                    window = (a, a + e.duration_ns() * 1e-9)
            continue
        if name.startswith(PREFIX) or e.duration_ns() <= 0:
            continue  # a range's own device row is not device work
        kernels.append((name, e.start_ns() * 1e-9, e.duration_ns() * 1e-9))
    if window is None:
        raise RuntimeError("the trace holds no portbench.window range")
    return Trace(kernels, ranges, window)
