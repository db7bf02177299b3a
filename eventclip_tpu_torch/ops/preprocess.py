"""CLIP image preprocessing on channel-first frames.

Port of eventclip_tpu/ops/preprocess.py: the torchvision/PIL transform CLIP
ships with (bicubic resize of the short side to `image_size`, center crop,
scale to [0, 1], channel normalize) as two resampling matmuls, with the
weights precomputed on the host exactly the way PIL's `precompute_coeffs`
does (Keys bicubic a = -0.5, support scaled by the shrink factor on
downscale, edge-clamped + renormalized).

The resampling error must stay below one uint8 quantum, so both matmuls run
in full float32: TF32 is switched off for them (the JAX package pins
`precision="highest"` here).
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache
from typing import Tuple

import numpy as np
import torch

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def _keys_cubic(x: np.ndarray, a: float = -0.5) -> np.ndarray:
    x = np.abs(x)
    return np.where(
        x < 1.0,
        ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0,
        np.where(x < 2.0, (((x - 5.0) * x + 8.0) * x - 4.0) * a, 0.0),
    )


@lru_cache(maxsize=32)
def resize_matrix(in_size: int, out_size: int) -> np.ndarray:
    """[in_size, out_size] float32 PIL-bicubic resampling matrix.

    Mirrors Pillow's `precompute_coeffs`: per output pixel, taps centered at
    (i + 0.5) * in/out with support 2 (scaled by the shrink factor when
    downscaling), window clipped to the image and weights renormalized.
    """
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    mat = np.zeros((in_size, out_size), dtype=np.float64)
    for i in range(out_size):
        center = (i + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size)
        taps = np.arange(xmin, xmax)
        w = _keys_cubic((taps + 0.5 - center) / filterscale)
        mat[xmin:xmax, i] = w / w.sum()
    return mat.astype(np.float32)


@dataclasses.dataclass(frozen=True)
class ClipPreprocess:
    """Static geometry of the resize+crop for one input resolution."""

    in_height: int
    in_width: int
    image_size: int = 224

    @property
    def resized(self) -> Tuple[int, int]:
        h, w, s = self.in_height, self.in_width, self.image_size
        if h <= w:
            return s, int(s * w / h)
        return int(s * h / w), s

    @property
    def crop_origin(self) -> Tuple[int, int]:
        rh, rw = self.resized
        s = self.image_size
        return int(round((rh - s) / 2.0)), int(round((rw - s) / 2.0))

    def matrices(self) -> Tuple[np.ndarray, np.ndarray]:
        """([H, S], [W, S]) resampling matrices with the crop folded in:
        only the cropped rows / columns of the resized image are produced."""
        rh, rw = self.resized
        s = self.image_size
        top, left = self.crop_origin
        mh = resize_matrix(self.in_height, rh)[:, top:top + s]
        mw = resize_matrix(self.in_width, rw)[:, left:left + s]
        return mh, mw


def preprocess_frames_chw(pp: ClipPreprocess,
                          frames: torch.Tensor) -> torch.Tensor:
    """[..., 3, H, W] float32 (0..255) -> [..., 3, S, S] CLIP-normalized."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    lead = frames.shape[:-3]
    H, W = pp.in_height, pp.in_width
    s = pp.image_size
    dev = frames.device
    mh, mw = (torch.from_numpy(m).to(dev) for m in pp.matrices())
    x = frames.to(torch.float32).reshape(-1, 3, H, W)
    x = torch.matmul(mh.T, x)  # [b, 3, S, W]
    x = torch.matmul(x, mw)  # [b, 3, S, S]
    # PIL stores the resized image as uint8 before ToTensor
    x = torch.clamp(torch.round(x), 0.0, 255.0) / 255.0
    mean = torch.tensor(CLIP_MEAN, dtype=torch.float32, device=dev)
    std = torch.tensor(CLIP_STD, dtype=torch.float32, device=dev)
    x = (x - mean[:, None, None]) / std[:, None, None]
    return x.reshape(lead + (3, s, s))
