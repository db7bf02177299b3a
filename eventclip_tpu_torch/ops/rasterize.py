"""Event windows -> frames on the device.

Port of eventclip_tpu/ops/rasterize.py (behavioral contract:
eventclip_tpu_torch.ops.numpy_ref, the oracle for the reference semantics of
datasets/vis.py:6-117). The per-window polarity histogram runs through the
hand-written kernel csrc/histogram.cu on a CUDA tensor (`histograms`), or
its plain PyTorch version on a CPU tensor. Everything downstream (hot-pixel
removal, normalization, colorization, white compositing, uint8 rounding and
the CLIP resize) is plain elementwise/reduction/matmul PyTorch, as it was
XLA-fused (not Pallas) in the JAX package.

Window layouts: [.., N, 4] float32 (x, y, t, p) and the packed
[.., N, 3] int16 (x, y, p); polarity is the last channel in both.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple, Union

import numpy as np
import torch

from .. import kernels
from .preprocess import ClipPreprocess, preprocess_frames_chw


@dataclasses.dataclass(frozen=True)
class RasterSpec:
    """Static parameters of the rasterizer."""

    height: int
    width: int
    window: int  # N, events per frame window
    thresh: float = 10.0
    count_non_zero: bool = False
    background_mask: bool = True
    grayscale: Union[bool, int] = True

    @property
    def resolution(self) -> Tuple[int, int]:
        return (self.height, self.width)

    def colormap(self) -> np.ndarray:
        """[2, 3] float32 colors for (positive, negative) events."""
        if self.grayscale:
            v = 127 if isinstance(self.grayscale, bool) else self.grayscale
            base = np.round(np.ones(3) * v).astype(np.uint8)
            return np.stack([base, base], axis=0).astype(np.float32)
        return np.array([[255, 0, 0], [0, 0, 255]], dtype=np.float32)


def histograms_plain(windows: torch.Tensor, height: int,
                     width: int) -> torch.Tensor:
    """[M, N, ch] windows -> float32 [M, 2, H, W] exact counts: +1 at row
    y + H*[p<0], column x; p == 0 or out-of-bounds events dropped."""
    H, W = height, width
    M, N, ch = windows.shape
    x = windows[..., 0].to(torch.int64)
    y = windows[..., 1].to(torch.int64)
    p = windows[..., ch - 1]
    live = (x >= 0) & (x < W) & (y >= 0) & (y < H) & (p != 0)
    m = torch.arange(M, device=windows.device)[:, None]
    flat = (m * 2 * H + y + H * (p < 0).to(torch.int64)) * W + x
    counts = torch.zeros(M * 2 * H * W, dtype=torch.int32,
                         device=windows.device)
    idx = flat[live]
    counts.index_put_((idx,), torch.ones_like(idx, dtype=torch.int32),
                      accumulate=True)
    return counts.to(torch.float32).reshape(M, 2, H, W)


def _check_windows(windows: torch.Tensor) -> None:
    if windows.dim() != 3 or windows.shape[-1] not in (3, 4):
        raise ValueError(
            f"expected windows [M, N, 3|4], got {tuple(windows.shape)}")
    if windows.dtype not in (torch.int16, torch.float32):
        raise TypeError(f"windows dtype {windows.dtype} is neither int16 "
                        "(packed) nor float32")
    if not windows.is_contiguous():
        raise ValueError("windows must be contiguous")


def histograms(windows: torch.Tensor, height: int,
               width: int) -> torch.Tensor:
    """[M, N, 4|3] event windows -> float32 [M, 2, H, W] count histograms.

    CUDA tensors run the histogram kernel (or raise); CPU tensors run
    `histograms_plain`."""
    _check_windows(windows)
    if windows.device.type == "cpu":
        return histograms_plain(windows, height, width)
    if windows.device.type != "cuda":
        raise ValueError(f"unsupported device {windows.device}")
    M, N, ch = windows.shape
    if N >= 1 << 24:  # the kernel counts in f32, exact below 2^24
        raise ValueError(f"window of {N} events: the histogram kernel "
                         "counts exactly only below 2^24 events")
    out = torch.empty((M, 2, height, width), dtype=torch.float32,
                      device=windows.device)
    lib = kernels.library("histogram")
    with torch.cuda.device(windows.device):
        stream = torch.cuda.current_stream(windows.device).cuda_stream
        rc = lib.event_histogram(
            windows.data_ptr(), M, N, ch, int(windows.dtype == torch.int16),
            height, width, out.data_ptr(), stream)
    kernels.check(lib, rc, "event_histogram")
    kernels.LAUNCHES["histogram"] += 1
    return out


def finish_frames_chw(spec: RasterSpec, hist: torch.Tensor) -> torch.Tensor:
    """Hot-pixel removal + normalize + colorize + composite (batched).

    [M, 2, H, W] counts -> [M, 3, H, W] float32 in [0, 255], rounded to
    integers (the value grid of the reference's uint8 frames)."""
    red = (1, 2, 3)
    if spec.thresh > 0:
        if spec.count_non_zero:
            nz = hist > 0
            cnt = torch.clamp(nz.sum(red, keepdim=True), min=1).to(
                torch.float32)
            mean = hist.sum(red, keepdim=True) / cnt
            var = torch.where(nz, (hist - mean) ** 2, 0.0).sum(
                red, keepdim=True) / cnt
        else:
            mean = hist.mean(red, keepdim=True)
            var = ((hist - mean) ** 2).mean(red, keepdim=True)
        cut = spec.thresh * torch.sqrt(var) + mean
        hist = torch.where(hist > cut, 0.0, hist)
    peak = hist.amax(red, keepdim=True)
    hist = hist / torch.where(peak > 0, peak, 1.0)
    cmap = torch.from_numpy(spec.colormap()).to(hist.device)
    img = (hist[:, 0:1] * cmap[0][None, :, None, None]
           + hist[:, 1:2] * cmap[1][None, :, None, None])  # [M, 3, H, W]
    if spec.background_mask:
        alpha = torch.clamp(hist.sum(1, keepdim=True), 0.0, 1.0)
        img = img * alpha + 255.0 * (1.0 - alpha)
    return torch.round(img)


def rasterize_chw(spec: RasterSpec, windows: torch.Tensor) -> torch.Tensor:
    """[..., N, 4|3] -> [..., 3, H, W] float32 frames (integer-valued)."""
    lead = windows.shape[:-2]
    flat = windows.reshape((-1,) + tuple(windows.shape[-2:])).contiguous()
    hists = histograms(flat, spec.height, spec.width)  # [M, 2, H, W]
    frames = finish_frames_chw(spec, hists)
    return frames.reshape(lead + frames.shape[-3:])


def rasterize_windows(spec: RasterSpec, windows: torch.Tensor) -> torch.Tensor:
    """[..., N, 4|3] event windows -> [..., H, W, 3] uint8 frames (the
    oracle's layout; the serving path uses `rasterize_for_clip`)."""
    return torch.movedim(rasterize_chw(spec, windows), -3, -1).to(torch.uint8)


def rasterize_for_clip(spec: RasterSpec, pp: ClipPreprocess,
                       windows: torch.Tensor) -> torch.Tensor:
    """Event windows -> [..., 3, S, S] float32 CLIP-normalized images,
    channel-first end to end (no HWC frame is materialized)."""
    return preprocess_frames_chw(pp, rasterize_chw(spec, windows))
