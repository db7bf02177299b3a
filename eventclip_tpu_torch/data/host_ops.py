"""Host-side event array operations.

O(n) index arithmetic over raw event streams stays on the host; all O(H*W)
image work runs on the card (eventclip_tpu_torch.ops). The host only ships
the selected windows -- [T, N, 3] int16 per sample -- to the device.

Port of eventclip_tpu/data/host_ops.py. The numpy functions below are the
behavioral reference; the hot per-item entry points (prepare_stream,
tta_variants, gather_event_windows) dispatch to the fused native C++
library (eventclip_tpu_torch/native) when it is available,
bit-identically (tests/test_torch_native.py).

Behavioral contracts (reference):
- center_events            datasets/utils.py:38-57
- shift_events             datasets/utils.py:4-15   (drops out-of-bounds!)
- hflip_events             datasets/utils.py:18-23
- tflip_events             datasets/utils.py:26-35
- window gather/subsample  datasets/vis.py:55-72 + datasets/event2img.py:80-92
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from .. import native
from ..ops.windows import event_count_windows


def center_events(events: np.ndarray, resolution: Tuple[int, int]) -> np.ndarray:
    """Zero-base timestamps and center the event bounding box in the frame.

    In-place on a float array. The spatial shift uses float floor-division,
    reproducing the reference's `((max + min + 1.) - size) // 2.` exactly.
    """
    H, W = resolution
    events[:, 2] -= events[:, 2].min()
    x_min, x_max = events[:, 0].min(), events[:, 0].max()
    y_min, y_max = events[:, 1].min(), events[:, 1].max()
    events[:, 0] -= ((x_max + x_min + 1.0) - W) // 2.0
    events[:, 1] -= ((y_max + y_min + 1.0) - H) // 2.0
    return events


def shift_events(
    events: np.ndarray,
    max_shift: int,
    resolution: Tuple[int, int],
    rng: np.random.Generator,
) -> np.ndarray:
    """Random spatial shift; events pushed out of frame are dropped."""
    dx, dy = rng.integers(-max_shift, max_shift + 1, size=2)
    return shift_events_by(events, int(dx), int(dy), resolution)


def shift_events_by(
    events: np.ndarray, dx: int, dy: int, resolution: Tuple[int, int]
) -> np.ndarray:
    """Deterministic spatial shift; events pushed out of frame are dropped."""
    H, W = resolution
    events[:, 0] += dx
    events[:, 1] += dy
    keep = (
        (events[:, 0] >= 0)
        & (events[:, 0] < W)
        & (events[:, 1] >= 0)
        & (events[:, 1] < H)
    )
    return events[keep]


def hflip_events(
    events: np.ndarray,
    resolution: Tuple[int, int],
    rng: Optional[np.random.Generator] = None,
    p: float = 0.5,
) -> np.ndarray:
    """Mirror events along x with probability p (p=1 for deterministic TTA)."""
    W = resolution[1]
    if p >= 1.0 or (rng is not None and rng.random() < p):
        events[:, 0] = W - 1 - events[:, 0]
    return events


def tflip_events(
    events: np.ndarray,
    rng: Optional[np.random.Generator] = None,
    p: float = 0.5,
) -> np.ndarray:
    """Reverse time with probability p: flip order, mirror t, negate polarity."""
    if p >= 1.0 or (rng is not None and rng.random() < p):
        events = np.ascontiguousarray(events[::-1])
        events[:, 2] = events[0, 2] - events[:, 2]
        events[:, 3] = -events[:, 3]
    return events


def draw_augment(
    rng: np.random.Generator, flip_time: bool, max_shift: int
) -> Tuple[bool, int, int, bool]:
    """Draw the (tflip, dx, dy, hflip) augmentation parameters, consuming
    the generator with exactly the reference's in-op draws in its order
    (tflip_events' rng.random(), shift_events' rng.integers(size=2),
    hflip_events' rng.random()), so draws keyed on (seed, epoch, idx)
    replay across versions."""
    tflip = bool(rng.random() < 0.5) if flip_time else False
    dx, dy = (int(v) for v in rng.integers(-max_shift, max_shift + 1, size=2))
    hflip = bool(rng.random() < 0.5)
    return tflip, dx, dy, hflip


def prepare_stream(
    events: np.ndarray,
    resolution: Tuple[int, int],
    rng: Optional[np.random.Generator] = None,
    augment: bool = False,
    flip_time: bool = False,
    max_shift: int = 0,
) -> np.ndarray:
    """center_events (+ the training augmentations) in one call: the fused
    native pass (one pass, GIL released) when the library is available,
    else the numpy ops above, bit-identically. Never mutates `events`; the
    augmentation draws come from `draw_augment`."""
    if augment:
        tflip, dx, dy, hflip = draw_augment(rng, flip_time, max_shift)
    if native.available():
        if not augment:
            return native.transform_events(events, resolution, center=True)
        return native.transform_events(
            events, resolution, center=True, tflip=tflip, shift=(dx, dy),
            hflip=hflip)
    events = center_events(events.astype(np.float32, copy=True), resolution)
    if not augment:
        return events
    if tflip:
        events = tflip_events(events, p=1.0)
    events = shift_events_by(events, dx, dy, resolution)
    if hflip:
        events = hflip_events(events, resolution=resolution, p=1.0)
    return events


def tta_variants(
    events: np.ndarray, resolution: Tuple[int, int]
) -> Tuple[np.ndarray, ...]:
    """The 4-way TTA family (id, h-flip, t-flip, h+t-flip) of an
    already-centered stream (reference datasets/event2img.py:94-112).
    h-flip and t-flip touch disjoint columns, so the native pass's
    tflip-then-hflip order is bit-identical to tflip(hflip(.))."""
    if native.available():
        tr = native.transform_events
        return (events,
                tr(events, resolution, hflip=True),
                tr(events, resolution, tflip=True),
                tr(events, resolution, tflip=True, hflip=True))
    h = hflip_events(events.copy(), resolution=resolution, p=1.0)
    # hflip mutates in place (hence the copy); tflip at p=1 always returns
    # a fresh array, so its inputs need no defensive copy
    t = tflip_events(events, p=1.0)
    ht = tflip_events(h, p=1.0)
    return events, h, t, ht


def max_views(max_n: int, window: int, hard_limit: int) -> int:
    """View budget: clamp(round(max_n / N), 1, hard_limit)
    (reference datasets/event2img.py:70-72)."""
    return max(min(round(max_n / window), hard_limit), 1)


def gather_event_windows(
    events: np.ndarray,
    window: int,
    num_views: int,
    rng: Optional[np.random.Generator] = None,
    packed: bool = False,
    *,
    out: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Split a stream into event-count windows and gather up to `num_views`.

    Returns:
        windows: [num_views, window, 4] float32 (x, y, t, p), or — with
            packed=True — [num_views, window, 3] int16 (x, y, p): the
            rasterizer never reads timestamps, and after centering/flipping
            x, y and p are small integral values. Short/empty slots are
            zero-padded with p == 0 rows (excluded by the rasterizer).
        valid:   [num_views] bool.

    When the stream yields more windows than slots, a random subset is taken
    in random order (reference torch.randperm semantics,
    datasets/event2img.py:83-86); otherwise windows keep stream order and
    the remaining slots are padding.

    `out`: a zeroed, writable, C-contiguous array of the windows' shape
    and dtype (one stream's slice of a request buffer) that receives the
    windows and is returned; only the spans' rows are written.
    """
    spans = event_count_windows(len(events), window)
    if len(spans) > num_views:
        if rng is None:
            raise ValueError(
                f"{len(spans)} windows for {num_views} slots needs an rng "
                "(the reference subsamples views randomly even in eval)"
            )
        sel = rng.permutation(len(spans))[:num_views]
        spans = [spans[i] for i in sel]
    valid = np.zeros((num_views,), dtype=bool)
    valid[: len(spans)] = True
    if native.available():
        return native.pack_spans(events, spans, num_views, window,
                                 packed=packed, out=out), valid
    if packed:
        out = native.out_buffer(out, (num_views, window, 3), np.int16)
        for i, (a, b) in enumerate(spans):
            out[i, : b - a] = events[a:b, (0, 1, 3)]  # x, y, p (t dropped)
        return out, valid
    out = native.out_buffer(out, (num_views, window, 4), np.float32)
    for i, (a, b) in enumerate(spans):
        out[i, : b - a] = events[a:b]
    return out, valid
