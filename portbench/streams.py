"""The one traffic generator: event streams and request schedules from a
traffic file's parameters and `--seed`.

A stream is a `[n, 4]` float32 x/y/t/p recording: a blob whose place,
size, drift and direction are drawn for the stream, over a share of
uniform sensor noise, polarity ±1, integral pixel coordinates (a sensor's
own). The shape follows chip_smoke.py's `synth_stream` and `synth_events`,
with the blob's place drawn per stream so that recordings differ.

Lengths are stratified: `levels` lengths spread evenly over
[min, max], the same set for every seed, `copies` distinct streams at
each. A request of a `levels`-stream batch takes one stream of every
level, so every request, whatever the seed, carries the same work; the
seed picks which copy and the order.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np


def lengths(spec: Dict[str, Any]) -> List[int]:
    """The stratified event counts of a traffic file's `events` entry."""
    lo, hi, levels = int(spec["min"]), int(spec["max"]), int(spec["levels"])
    return [lo + int(round((i + 0.5) * (hi - lo) / levels))
            for i in range(levels)]


def blob_stream(rng: np.random.Generator, n: int, height: int, width: int,
                p: Dict[str, Any]) -> np.ndarray:
    """One `[n, 4]` stream (see the module docstring)."""
    dur = float(p["duration_s"])
    t = np.sort(rng.uniform(0.0, dur, n))
    cx0 = rng.uniform(0.2, 0.8) * width
    cy0 = rng.uniform(0.2, 0.8) * height
    sx, sy = rng.uniform(*p["blob_sigma"], size=2) * np.array(
        [width, height])
    ang = rng.uniform(0.0, 2 * np.pi)
    drift = rng.uniform(*p["drift"]) * width
    phase = t / dur - 0.5
    cx = cx0 + drift * np.cos(ang) * phase + rng.normal(0.0, sx, n)
    cy = cy0 + drift * np.sin(ang) * phase + rng.normal(0.0, sy, n)
    noise = rng.random(n) < float(p["noise"])
    x = np.where(noise, rng.integers(0, width, n), np.clip(cx, 0, width - 1))
    y = np.where(noise, rng.integers(0, height, n),
                 np.clip(cy, 0, height - 1))
    pol = np.where(rng.random(n) < 0.5, -1.0, 1.0)
    return np.stack([np.floor(x), np.floor(y), t, pol], 1).astype(np.float32)


def stream_pool(traffic: Dict[str, Any], geometry: Tuple[int, int],
                seed: int) -> List[List[np.ndarray]]:
    """pool[level][copy]: every stream of a run, made from the seed."""
    h, w = geometry
    copies = int(traffic["copies"])
    return [[blob_stream(np.random.default_rng((seed, lvl, c)), n, h, w,
                         traffic["stream"]) for c in range(copies)]
            for lvl, n in enumerate(lengths(traffic["events"]))]


def request_schedule(traffic: Dict[str, Any], seed: int):
    """Endless (level, copy) lists, one per request: a stream of every
    level, in an order and of a copy drawn from the seed."""
    rng = np.random.default_rng((seed, 0x5EED))
    levels, copies = int(traffic["events"]["levels"]), int(traffic["copies"])
    while True:
        order = rng.permutation(levels)
        pick = rng.integers(0, copies, levels)
        yield [(int(lvl), int(pick[lvl])) for lvl in order]
