"""Reference frames, in plain PyTorch float32: event windows to CLIP inputs.

EventCLIP's `event_histogram` conversion (`datasets/vis.py`) and CLIP's
image transform (`clip/clip.py::_transform` of openai/CLIP):

- a window's events are counted per pixel and polarity (p > 0, p < 0);
  events off the frame or with p == 0 are not counted;
- hot pixels are removed: counts above mean + thresh * std of the whole
  [2, H, W] count array become 0 (thresh 10);
- counts are divided by their maximum, coloured (grey 127 for both
  polarities), composited over white by alpha = min(pos + neg, 1), and
  rounded to integers;
- CLIP's transform: bicubic resize of the short side to the image size
  (Pillow's coefficients: Keys a = -0.5, support scaled by the shrink
  factor, window clipped to the image and renormalised), centre crop,
  rounding to uint8, [0, 1], per-channel normalisation.

One departure, which the served path makes too: Pillow rounds to uint8
between its horizontal and vertical passes; here, as there, the two
passes run in float32 and are rounded once.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def histograms(windows, height: int, width: int, device) -> torch.Tensor:
    """list of [m, 3] x/y/p arrays -> [V, 2, H, W] float32 counts."""
    out = torch.zeros((len(windows), 2 * height * width), dtype=torch.int64,
                      device=device)
    for i, w in enumerate(windows):
        w = torch.from_numpy(np.ascontiguousarray(w)).to(device)
        x, y, p = w[:, 0].long(), w[:, 1].long(), w[:, 2]
        keep = (x >= 0) & (x < width) & (y >= 0) & (y < height) & (p != 0)
        idx = ((p[keep] < 0).long() * height + y[keep]) * width + x[keep]
        out[i] = torch.bincount(idx, minlength=2 * height * width)
    return out.float().reshape(len(windows), 2, height, width)


def frames(hist: torch.Tensor, thresh: float = 10.0,
           grey: float = 127.0) -> torch.Tensor:
    """[V, 2, H, W] counts -> [V, 3, H, W] float32 integral 0..255."""
    red = (1, 2, 3)
    mean = hist.mean(red, keepdim=True)
    std = torch.sqrt(((hist - mean) ** 2).mean(red, keepdim=True))
    hist = torch.where(hist > thresh * std + mean, 0.0, hist)
    peak = hist.amax(red, keepdim=True)
    hist = hist / torch.where(peak > 0, peak, 1.0)
    img = hist[:, 0:1] * grey + hist[:, 1:2] * grey
    alpha = torch.clamp(hist[:, 0:1] + hist[:, 1:2], 0.0, 1.0)
    img = img * alpha + 255.0 * (1.0 - alpha)
    return torch.round(img).expand(-1, 3, -1, -1)


def _cubic(x: np.ndarray, a: float = -0.5) -> np.ndarray:
    x = np.abs(x)
    return np.where(x < 1, ((a + 2) * x - (a + 3)) * x * x + 1,
                    np.where(x < 2, (((x - 5) * x + 8) * x - 4) * a, 0.0))


@lru_cache(maxsize=8)
def bicubic(in_size: int, out_size: int) -> np.ndarray:
    """[in, out] float64 Pillow bicubic resampling weights."""
    scale = in_size / out_size
    fscale = max(scale, 1.0)
    support = 2.0 * fscale
    m = np.zeros((in_size, out_size))
    for o in range(out_size):
        c = (o + 0.5) * scale
        lo = max(int(c - support + 0.5), 0)
        hi = min(int(c + support + 0.5), in_size)
        taps = np.arange(lo, hi)
        w = _cubic((taps - c + 0.5) / fscale)
        m[lo:hi, o] = w / w.sum()
    return m


def clip_inputs(img: torch.Tensor, size: int = 224) -> torch.Tensor:
    """[V, 3, H, W] 0..255 -> [V, 3, size, size] CLIP-normalised."""
    h, w = img.shape[-2:]
    rh, rw = (size, int(size * w / h)) if h <= w else (int(size * h / w),
                                                       size)
    top, left = int(round((rh - size) / 2.0)), int(round((rw - size) / 2.0))
    mh = torch.from_numpy(bicubic(h, rh)[:, top:top + size]).float()
    mw = torch.from_numpy(bicubic(w, rw)[:, left:left + size]).float()
    x = mh.to(img.device).T @ img.float() @ mw.to(img.device)
    x = torch.clamp(torch.round(x), 0, 255) / 255.0
    mean = torch.tensor(CLIP_MEAN, device=img.device)[:, None, None]
    std = torch.tensor(CLIP_STD, device=img.device)[:, None, None]
    return (x - mean) / std
