"""Event windows -> frames on the device.

Port of eventclip_tpu/ops/rasterize.py (behavioral contract:
eventclip_tpu_torch.ops.numpy_ref, the oracle for the reference semantics of
datasets/vis.py:6-117). The per-window polarity histogram runs through the
hand-written kernel csrc/histogram.cu on a CUDA tensor (`histograms`, the
custom op `eventclip::event_histogram`), or its plain PyTorch version on a
CPU tensor. Everything downstream (hot-pixel
removal, normalization, colorization, white compositing, uint8 rounding and
the CLIP resize, and on the training path RandAugment) is plain
elementwise/reduction/gather/matmul PyTorch, as it was XLA-fused (not
Pallas) in the JAX package.

Window layouts: [.., N, 4] float32 (x, y, t, p) and the packed
[.., N, 3] int16 (x, y, p); polarity is the last channel in both.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple, Union

import numpy as np
import torch
from torch.profiler import record_function

from .. import kernels
from .preprocess import ClipPreprocess, preprocess_frames_chw
from .randaugment import apply_ops


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


SMEM_LIMIT = 232448  # shared memory a Hopper block may use (227 KB)
MAX_CLUSTER = 16  # CTAs in a cluster (above 8: a non-portable size)


@dataclasses.dataclass(frozen=True)
class HistogramPlan:
    """How csrc/histogram.cu splits one window's [2H, W] plane: clusters of
    `cluster` CTAs, each CTA owning `rows` consecutive rows in its shared
    memory (u32 counts), `bands` clusters a window. CTA c of band b owns
    rows [(b * cluster + c) * rows, + rows), clipped to 2H."""

    cluster: int
    rows: int
    bands: int

    def row_ranges(self, height: int):
        """[(first, end)] plane rows of every CTA of one window, band by
        band (empty ranges past 2H included)."""
        R = 2 * height
        return [(min(i * self.rows, R), min((i + 1) * self.rows, R))
                for i in range(self.cluster * self.bands)]

    def smem_bytes(self, width: int) -> int:
        return -(-self.rows * width // 4) * 16


def histogram_plan(height: int, width: int,
                   smem_limit: int = SMEM_LIMIT) -> HistogramPlan:
    """The cluster, rows a CTA and bands for an H x W frame.

    A CTA takes at most a third of an SM's shared memory, so three share an
    SM and one's stores overlap the others' counting (on the card this beat
    one or two CTAs an SM at 180x240 and 480x640, and four, whose frames
    need twice the bands). A cluster is the least power of two of such
    CTAs that covers the 2H rows; a frame too large for 16 of them runs in
    row bands of 16 CTAs, each band reading the window's events once."""
    R, row_bytes = 2 * height, 4 * width
    # the SM holds the block limit plus one 1 KiB reserve a resident block
    budget = (smem_limit + 1024) // 3 - 1024
    if row_bytes > budget:  # a very wide frame: one CTA an SM
        budget = smem_limit
    if row_bytes > budget:
        raise ValueError(f"a frame row of {width} pixels does not fit in "
                         f"{budget} bytes of shared memory")
    ctas = -(-R // (budget // row_bytes))
    if ctas <= MAX_CLUSTER:
        cluster = 1 << (ctas - 1).bit_length()
        return HistogramPlan(cluster, -(-R // cluster), 1)
    bands = -(-ctas // MAX_CLUSTER)
    return HistogramPlan(MAX_CLUSTER, -(-R // (MAX_CLUSTER * bands)), bands)


def device_histogram_plan(device: torch.device, height: int,
                          width: int) -> HistogramPlan:
    """`histogram_plan` for the shared memory of the CUDA card `device`:
    the plan `histograms` launches there."""
    props = torch.cuda.get_device_properties(device)
    return histogram_plan(height, width, getattr(
        props, "shared_memory_per_block_optin", SMEM_LIMIT))


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
    """[M, N, 4|3] event windows -> float32 [M, 2, H, W] count histograms,
    through `eventclip::event_histogram` (ops/custom_ops.py).

    CUDA tensors run the histogram kernel (or raise) under
    `device_histogram_plan`, chosen at run time; CPU tensors run
    `histograms_plain`."""
    _check_windows(windows)
    return torch.ops.eventclip.event_histogram(windows, height, width)


def launch_histograms(windows: torch.Tensor, height: int, width: int,
                      plan: HistogramPlan) -> torch.Tensor:
    """The histogram kernel on CUDA windows under a given plan (checked
    windows; `histograms` passes its own plan, kernel_variants.py and the
    card tests others)."""
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
            height, width, plan.cluster, plan.rows, plan.bands,
            out.data_ptr(), stream)
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


def rasterize_augment_for_clip(spec: RasterSpec, pp: ClipPreprocess,
                               windows: torch.Tensor, op_idx: torch.Tensor,
                               mag: torch.Tensor) -> torch.Tensor:
    """Training-path `rasterize_for_clip` with RandAugment between the
    frames and the resize: [B, T, N, 4|3] windows and the draws op_idx / mag
    [B, num_ops] (ops.randaugment.sample_ops) -> [B, T, 3, S, S]. The
    reference augments the uint8 frames before the CLIP transforms
    (datasets/event2img.py:120-127); the fill matches the background mode.
    Grayscale colormaps give R = G = B and every op keeps channels equal,
    so those frames are augmented on one channel and broadcast."""
    op_idx = op_idx.cpu()  # read before the frames are queued
    frames = rasterize_chw(spec, windows)  # [B, T, 3, H, W]
    fill = 255.0 if spec.background_mask else 0.0
    with record_function("randaugment"):
        if spec.grayscale:
            frames = apply_ops(frames[:, :, :1], op_idx, mag, fill).expand(
                frames.shape)
        else:
            frames = apply_ops(frames, op_idx, mag, fill)
    return preprocess_frames_chw(pp, frames)
