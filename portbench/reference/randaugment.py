"""Reference RandAugment, in plain PyTorch float32: the 14 ops of
torchvision's RandAugment (the version EventCLIP vendors as
`datasets/augment.py`), one frame at a time, on 3-channel frames whose
values are the integers 0..255 of a uint8 image.

- The draws: one magnitude bin (of 30) a sample, an op (of 14) and a
  sign flip (p = 0.5, signed ops only) a sample and op, from a
  `torch.Generator` in that order (the program's seeding contract:
  `randint` bins, `randint` ops, `rand` flips). Every view of a sample
  gets its sample's ops, one after the other.
- Geometric ops (torchvision's tensor path): the inverse affine map of
  `_get_inverse_affine_matrix` in float64, its sampling grid, bicubic
  `grid_sample` (a = -0.75, zeros outside), blended with the white fill
  through the grid-sampled frame of ones, rounded, clamped. Shears turn
  about the top-left corner, the other ops about the centre; Rotate turns
  by the negated angle, as `F.rotate` passes it.
- Pixel ops with uint8 semantics: blends truncate to integers;
  Color's grey is the truncated luma; Contrast blends with the luma's
  mean rounded half up (PIL's `ImageEnhance.Contrast`); Sharpness blends
  with the 3x3 (1 1 1 / 1 5 1 / 1 1 1) / 13 smoothing of the interior,
  rounded; Posterize masks the low bits; Solarize inverts from the
  threshold up; AutoContrast stretches each channel's range to 0..255;
  Equalize maps each channel through its cumulative histogram.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

OPS = ("Identity", "ShearX", "ShearY", "TranslateX", "TranslateY", "Rotate",
       "Brightness", "Color", "Contrast", "Sharpness", "Posterize",
       "Solarize", "AutoContrast", "Equalize")
BINS = 30
SIGNED = {"ShearX", "ShearY", "TranslateX", "TranslateY", "Rotate",
          "Brightness", "Color", "Contrast", "Sharpness"}


def magnitudes(height: int, width: int) -> torch.Tensor:
    """[14, 30] float32: torchvision's `_augmentation_space(30, (H, W))`."""
    lin = torch.linspace
    zero = torch.zeros(BINS)
    table = {
        "Identity": zero,
        "ShearX": lin(0.0, 0.3, BINS), "ShearY": lin(0.0, 0.3, BINS),
        "TranslateX": lin(0.0, 150.0 / 331.0 * width, BINS),
        "TranslateY": lin(0.0, 150.0 / 331.0 * height, BINS),
        "Rotate": lin(0.0, 30.0, BINS),
        "Brightness": lin(0.0, 0.9, BINS), "Color": lin(0.0, 0.9, BINS),
        "Contrast": lin(0.0, 0.9, BINS), "Sharpness": lin(0.0, 0.9, BINS),
        "Posterize": 8 - (torch.arange(BINS) / ((BINS - 1) / 4)).round(),
        "Solarize": lin(255.0, 0.0, BINS),
        "AutoContrast": zero, "Equalize": zero,
    }
    return torch.stack([table[k].float() for k in OPS])


def draws(generator: torch.Generator, batch: int, num_ops: int,
          height: int, width: int) -> Tuple[list, list]:
    """-> (op names [batch][num_ops], magnitudes [batch][num_ops] floats)."""
    dev = generator.device
    bins = torch.randint(0, BINS, (batch,), generator=generator, device=dev)
    ops = torch.randint(0, len(OPS), (batch, num_ops), generator=generator,
                        device=dev)
    flip = torch.rand((batch, num_ops), generator=generator, device=dev) < 0.5
    table = magnitudes(height, width)
    bins, ops, flip = bins.cpu(), ops.cpu(), flip.cpu()
    names, mags = [], []
    for b in range(batch):
        names.append([OPS[int(o)] for o in ops[b]])
        mags.append([float(table[int(o), int(bins[b])])
                     * (-1.0 if OPS[int(o)] in SIGNED and bool(f) else 1.0)
                     for o, f in zip(ops[b], flip[b])])
    return names, mags


# -- geometric ops -----------------------------------------------------------


def inverse_affine(center, angle, translate, shear):
    """torchvision `_get_inverse_affine_matrix` at scale 1, in float64."""
    rot = math.radians(angle)
    sx, sy = math.radians(shear[0]), math.radians(shear[1])
    cx, cy = center
    tx, ty = translate
    a = math.cos(rot - sy) / math.cos(sy)
    b = -math.cos(rot - sy) * math.tan(sx) / math.cos(sy) - math.sin(rot)
    c = math.sin(rot - sy) / math.cos(sy)
    d = -math.sin(rot - sy) * math.tan(sx) / math.cos(sy) + math.cos(rot)
    m = [d, -b, 0.0, -c, a, 0.0]
    m[2] += m[0] * (-cx - tx) + m[1] * (-cy - ty) + cx
    m[5] += m[3] * (-cx - tx) + m[4] * (-cy - ty) + cy
    return m


def affine(img: torch.Tensor, matrix, fill: float) -> torch.Tensor:
    """[3, H, W] through the inverse map (torchvision `F_t.affine`)."""
    _, H, W = img.shape
    dev = img.device
    theta = torch.tensor(matrix, dtype=torch.float32, device=dev).reshape(
        1, 2, 3)
    xs = torch.linspace(-W * 0.5 + 0.5, W * 0.5 - 0.5, W, device=dev)
    ys = torch.linspace(-H * 0.5 + 0.5, H * 0.5 - 0.5, H, device=dev)
    base = torch.stack([xs[None, :].expand(H, W), ys[:, None].expand(H, W),
                        torch.ones(H, W, device=dev)], -1)
    scaled = theta.transpose(1, 2) / torch.tensor([0.5 * W, 0.5 * H],
                                                  device=dev)
    grid = (base.reshape(1, H * W, 3) @ scaled).reshape(1, H, W, 2)
    x = torch.cat([img, torch.ones_like(img[:1])])[None]
    out = F.grid_sample(x, grid, mode="bicubic", padding_mode="zeros",
                        align_corners=False)[0]
    mask = out[-1:]
    res = out[:-1] * mask + (1.0 - mask) * fill
    return torch.clamp(torch.round(res), 0.0, 255.0)


def geometric(img, name, mag, fill):
    _, H, W = img.shape
    if name in ("ShearX", "ShearY"):
        deg = math.degrees(math.atan(mag))
        shear = (deg, 0.0) if name == "ShearX" else (0.0, deg)
        m = inverse_affine((-W * 0.5, -H * 0.5), 0.0, (0.0, 0.0), shear)
    elif name in ("TranslateX", "TranslateY"):
        t = (float(int(mag)), 0.0) if name == "TranslateX" else (
            0.0, float(int(mag)))
        m = inverse_affine((0.0, 0.0), 0.0, t, (0.0, 0.0))
    else:  # Rotate
        m = inverse_affine((0.0, 0.0), -mag, (0.0, 0.0), (0.0, 0.0))
    return affine(img, m, fill)


# -- pixel ops ---------------------------------------------------------------


def blend(a: torch.Tensor, b: torch.Tensor, ratio: float) -> torch.Tensor:
    return torch.trunc(torch.clamp(ratio * a + (1.0 - ratio) * b, 0.0,
                                   255.0))


def luma(img: torch.Tensor) -> torch.Tensor:
    return torch.trunc(0.2989 * img[0] + 0.587 * img[1] + 0.114 * img[2])


def equalize_channel(ch: torch.Tensor) -> torch.Tensor:
    hist = torch.bincount(ch.long().reshape(-1), minlength=256).double()
    nonzero = hist[hist != 0]
    step = math.floor(float(nonzero[:-1].sum()) / 255.0)
    if step == 0:
        return ch
    lut = torch.floor((torch.cumsum(hist, 0) + step // 2) / step)
    lut = torch.clamp(torch.cat([hist.new_zeros(1), lut[:-1]]), 0.0, 255.0)
    return lut.float()[ch.long()]


def pixel(img, name, mag):
    if name == "Brightness":
        return blend(img, torch.zeros_like(img), 1.0 + mag)
    if name == "Color":
        return blend(img, luma(img).expand_as(img), 1.0 + mag)
    if name == "Contrast":
        H, W = img.shape[-2:]
        mean = math.floor(float(luma(img).double().sum()) / (H * W) + 0.5)
        return blend(img, torch.full_like(img, float(mean)), 1.0 + mag)
    if name == "Sharpness":
        k = torch.ones(3, 3, device=img.device)
        k[1, 1] = 5.0
        k = (k / k.sum()).expand(3, 1, 3, 3)
        smooth = F.conv2d(img[None], k, groups=3)[0]
        degen = img.clone()
        degen[:, 1:-1, 1:-1] = torch.clamp(torch.round(smooth), 0.0, 255.0)
        return blend(img, degen, 1.0 + mag)
    if name == "Posterize":
        mask = -int(2 ** (8 - int(mag)))
        return (img.to(torch.uint8) & (mask & 0xFF)).float()
    if name == "Solarize":
        return torch.where(img >= mag, 255.0 - img, img)
    if name == "AutoContrast":
        lo = img.amin((1, 2), keepdim=True)
        hi = img.amax((1, 2), keepdim=True)
        scale = 255.0 / (hi - lo)
        same = hi == lo
        scale = torch.where(same, 1.0, scale)
        lo = torch.where(same, 0.0, lo)
        return torch.trunc(torch.clamp((img - lo) * scale, 0.0, 255.0))
    if name == "Equalize":
        return torch.stack([equalize_channel(c) for c in img])
    raise ValueError(name)


def apply_op(img: torch.Tensor, name: str, mag: float,
             fill: float = 255.0) -> torch.Tensor:
    """One op on one [3, H, W] frame of integral values 0..255."""
    if name == "Identity":
        return img
    if name in ("ShearX", "ShearY", "TranslateX", "TranslateY", "Rotate"):
        return geometric(img, name, mag, fill)
    return pixel(img, name, mag)
