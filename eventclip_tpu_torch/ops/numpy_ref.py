"""Numpy oracle for the event->frame conversion.

A from-scratch implementation of the behavioral contract of the reference
rasterizer (datasets/vis.py:6-117): per-polarity event-count histograms with
hot-pixel suppression, global-max normalization, colorization and white
background compositing. Used as the golden oracle for the histogram
kernel and the frame finish stage (tests/test_torch_rasterize.py,
chip_smoke.py). A copy of eventclip_tpu/ops/numpy_ref.py, kept here so the
port never imports the JAX package.

Semantics notes (all matching the reference):
- events with p == 0 contribute to neither polarity channel;
- hot-pixel threshold is mean + thresh*std of the [H, W, 2] histogram, with
  the statistics optionally restricted to non-zero entries (count_non_zero);
- normalization divides by the global max AFTER hot-pixel removal;
- grayscale mode maps both polarities to (v, v, v) with v = 127 by default;
  color mode maps positive->red (255,0,0), negative->blue (0,0,255);
- background compositing alpha = clip(pos + neg, 0, 1) over pure white;
- output is rounded (round-half-even, numpy) to uint8.
"""

from __future__ import annotations

import numpy as np

from .windows import event_count_windows


def polarity_histogram(x, y, p, shape):
    """Per-polarity event count image, int64 [H, W, 2]."""
    H, W = shape
    x = x.astype(np.int64)
    y = y.astype(np.int64)
    flat = y * W + x
    pos = np.bincount(flat[p > 0], minlength=H * W).reshape(H, W)
    neg = np.bincount(flat[p < 0], minlength=H * W).reshape(H, W)
    return np.stack([pos, neg], axis=-1)


def remove_hot_pixels(hist, thresh=10.0, count_non_zero=False):
    if thresh <= 0:
        return hist
    stats_src = hist[hist > 0] if count_non_zero else hist
    mean = stats_src.mean()
    std = stats_src.std()
    out = hist.copy()
    out[out > thresh * std + mean] = 0
    return out


def colorize(hist, grayscale=True, background_mask=True):
    """Normalize a [H, W, 2] histogram and map to a uint8 [H, W, 3] image.

    Arithmetic intentionally stays in float32 end-to-end (the reference runs
    numpy 1.x where `float32_array / int_scalar` keeps float32).
    """
    hist = hist.astype(np.float32) / np.float32(hist.max())
    if grayscale:
        v = 127 if isinstance(grayscale, bool) else grayscale
        base = np.round(np.ones(3) * v).astype(np.uint8)
        cmap = np.stack([base, base], axis=0).astype(np.float32)
    else:
        cmap = np.array([[255, 0, 0], [0, 0, 255]], dtype=np.float32)
    img = hist @ cmap  # [H, W, 3]
    if background_mask:
        alpha = np.clip(hist.sum(-1, keepdims=True), 0.0, 1.0)
        img = img * alpha + 255.0 * (1.0 - alpha)
    return np.round(img).astype(np.uint8)


def events_to_frames_np(
    events,
    N,
    shape,
    thresh=10.0,
    count_non_zero=False,
    background_mask=True,
    grayscale=True,
):
    """Full oracle: [n, 4 (x, y, t, p)] events -> [T, H, W, 3] uint8 frames."""
    events = np.asarray(events)
    x, y, p = (
        events[:, 0].astype(np.int32),
        events[:, 1].astype(np.int32),
        events[:, 3].astype(np.int32),
    )
    frames = []
    for i0, i1 in event_count_windows(len(events), int(N)):
        hist = polarity_histogram(x[i0:i1], y[i0:i1], p[i0:i1], shape)
        hist = remove_hot_pixels(hist, thresh=thresh, count_non_zero=count_non_zero)
        frames.append(
            colorize(hist, grayscale=grayscale, background_mask=background_mask)
        )
    return np.stack(frames)
