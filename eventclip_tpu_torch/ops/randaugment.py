"""On-device RandAugment (the reference's image-space augmentation).

Port of eventclip_tpu/ops/randaugment.py: the reference's vendored
torchvision RandAugment (datasets/augment.py) over batched channel-first
frames that hold integer values 0..255 (the uint8 grid) as float32, with
its two deliberate quirks:

- ops and magnitude are drawn once per *sample* and the same ops go to
  every view of that sample (augment.py:142-178);
- bicubic interpolation with a white fill outside the frame, matching the
  white event background (datasets/event2img.py:37-42).

Op space: the reference's 14 entries (augment.py:123-140). One magnitude
bin (0..29) per sample; signed ops flip sign with p = 0.5. The draws come
from an explicit `torch.Generator` (`sample_ops`); `apply_ops` takes them
as given.

These are XLA ops in the JAX package, so here they are PyTorch ops. The
JAX package computes every op for every image and selects (a vmapped
switch, then selector matmuls for the warp's taps, as the TPU has no fast
gather). Here the op indices come to the host once per call, the frames
are grouped by op, and each group runs only its op: the geometric ops
share one inverse-affine bicubic warp (16 gathers, one per tap), each
pixel op runs batched. Equalize counts with `bincount` and maps with a
gather. Sums whose order the JAX package leaves to XLA (the warp's taps,
the sharpness blur) are taken in a fixed order, so the card and the CPU
give the same frames up to their `cos` / `sin` / `atan`.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import torch

N_MAGNITUDE_BINS = 30
OP_NAMES = (
    "Identity", "ShearX", "ShearY", "TranslateX", "TranslateY", "Rotate",
    "Brightness", "Color", "Contrast", "Sharpness", "Posterize", "Solarize",
    "AutoContrast", "Equalize",
)
SIGNED = (False, True, True, True, True, True, True, True, True, True,
          False, False, False, False)
GEOMETRIC = (1, 2, 3, 4, 5)


def magnitude_table(height: int, width: int) -> torch.Tensor:
    """[n_ops, 30] magnitude per (op, bin), matching _augmentation_space.
    Made on the CPU: a CUDA division by a scalar multiplies by its
    reciprocal, which is not the JAX package's f32 division."""
    bins = torch.arange(N_MAGNITUDE_BINS, dtype=torch.float32)
    lin = bins / (N_MAGNITUDE_BINS - 1)
    zeros = torch.zeros_like(bins)
    return torch.stack([
        zeros,  # Identity
        0.3 * lin,  # ShearX
        0.3 * lin,  # ShearY
        150.0 / 331.0 * width * lin,  # TranslateX
        150.0 / 331.0 * height * lin,  # TranslateY
        30.0 * lin,  # Rotate
        0.9 * lin,  # Brightness
        0.9 * lin,  # Color
        0.9 * lin,  # Contrast
        0.9 * lin,  # Sharpness
        8.0 - torch.round(bins / ((N_MAGNITUDE_BINS - 1) / 4.0)),  # Posterize
        255.0 - 255.0 * lin,  # Solarize
        zeros,  # AutoContrast
        zeros,  # Equalize
    ])


def sample_ops(generator: torch.Generator, batch: int, num_ops: int,
               height: int, width: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-sample draws on the generator's device: op indices [B, num_ops]
    int64 and signed magnitudes [B, num_ops] f32 (one magnitude bin per
    sample, an op index and a sign flip per sample and step)."""
    dev = generator.device
    mag_bins = torch.randint(0, N_MAGNITUDE_BINS, (batch,),
                             generator=generator, device=dev)
    op_idx = torch.randint(0, len(OP_NAMES), (batch, num_ops),
                           generator=generator, device=dev)
    flip = torch.rand((batch, num_ops), generator=generator, device=dev) < 0.5
    mag = magnitude_table(height, width).to(dev)[op_idx, mag_bins[:, None]]
    signed = torch.tensor(SIGNED, device=dev)[op_idx]
    return op_idx, torch.where(signed & flip, -mag, mag)


# ---------------------------------------------------------------------------
# bicubic inverse-affine warp (torch grid_sample parity)
# ---------------------------------------------------------------------------


def _cubic_weight(t: torch.Tensor, k: int, a: float = -0.75) -> torch.Tensor:
    """Cubic convolution weight of tap k (0..3) at fractional offset t in
    [0, 1) from tap 1: taps 1 and 2 lie within distance 1 (the inner
    branch), taps 0 and 3 at 1 to 2 (the outer one). Where a distance is
    exactly 1 or 2 both branches give 0, so this is the two-branch
    select, bit for bit, without computing the branch it drops."""
    d = (t + 1.0, t, 1.0 - t, 2.0 - t)[k]
    if k in (1, 2):
        return ((a + 2.0) * d - (a + 3.0)) * d * d + 1.0
    return (((d - 5.0) * d + 8.0) * d - 4.0) * a


def _inverse_affine_matrix(angle_deg, translate, shear_deg, center_off):
    """torchvision _get_inverse_affine_matrix (scale 1) on [N] tensors:
    the 6 inverse-map coefficients (m0..m5), src_x = m0 x + m1 y + m2,
    src_y = m3 x + m4 y + m5 in pixel coordinates about the image centre;
    `center_off` is the centre relative to the image centre."""
    rot = angle_deg * (math.pi / 180.0)
    sx = shear_deg[0] * (math.pi / 180.0)
    sy = shear_deg[1] * (math.pi / 180.0)
    cx, cy = center_off
    tx, ty = translate
    a = torch.cos(rot - sy) / torch.cos(sy)
    b = -torch.cos(rot - sy) * torch.tan(sx) / torch.cos(sy) - torch.sin(rot)
    c = torch.sin(rot - sy) / torch.cos(sy)
    d = -torch.sin(rot - sy) * torch.tan(sx) / torch.cos(sy) + torch.cos(rot)
    m0, m1, m3, m4 = d, -b, -c, a
    m2 = m0 * (-cx - tx) + m1 * (-cy - ty) + cx
    m5 = m3 * (-cx - tx) + m4 * (-cy - ty) + cy
    return m0, m1, m2, m3, m4, m5


def _geo_matrices(op: torch.Tensor, mag: torch.Tensor, height: int,
                  width: int):
    """[N] geometric op indices (1..5) + magnitudes -> 6 x [N] coefficients.
    Shears turn about the top-left corner (the reference's center=[0, 0]),
    the rest about the centre; a positive rotation turns counterclockwise
    (the angle is negated before the inverse matrix, as PIL and
    torchvision's tensor path do)."""
    deg = torch.rad2deg(torch.atan(mag))
    zero = torch.zeros_like(mag)
    angle = torch.where(op == 5, -mag, zero)
    sx = torch.where(op == 1, deg, zero)
    sy = torch.where(op == 2, deg, zero)
    tx = torch.where(op == 3, torch.trunc(mag), zero)
    ty = torch.where(op == 4, torch.trunc(mag), zero)
    is_shear = (op == 1) | (op == 2)
    cx = torch.where(is_shear, -width * 0.5, zero)
    cy = torch.where(is_shear, -height * 0.5, zero)
    return _inverse_affine_matrix(angle, (tx, ty), (sx, sy), (cx, cy))


def warp(imgs: torch.Tensor, mats, fill: float) -> torch.Tensor:
    """[N, C, H, W] frames warped by per-frame inverse maps (6 x [N]):
    grid_sample's bicubic (a = -0.75) with zero padding, blended with
    `fill` through the warped mask of the frame (separable: my * mx),
    rounded and clamped to 0..255. The 16 taps are gathered one at a time
    and summed over the rows first, then the columns."""
    N, C, H, W = imgs.shape
    Q = H * W
    m0, m1, m2, m3, m4, m5 = (m.float()[:, None, None] for m in mats)
    dev = imgs.device
    ox = (torch.arange(W, dtype=torch.float32, device=dev) + 0.5
          - W / 2.0)[None, None, :]
    oy = (torch.arange(H, dtype=torch.float32, device=dev) + 0.5
          - H / 2.0)[None, :, None]
    gx = (m0 * ox + m1 * oy + m2 + W / 2.0 - 0.5).reshape(N, Q)
    gy = (m3 * ox + m4 * oy + m5 + H / 2.0 - 0.5).reshape(N, Q)
    x0, y0 = torch.floor(gx), torch.floor(gy)
    fx, fy = gx - x0, gy - y0
    x0, y0 = x0.long(), y0.long()

    # each tap's weight is zeroed where the tap leaves the frame (grid
    # sample's zero padding); the mask of the frame is the sum of them
    my = mx = None
    rows: List[Tuple[torch.Tensor, torch.Tensor]] = []
    cols: List[Tuple[torch.Tensor, torch.Tensor]] = []
    for k in range(4):
        ty, tx = y0 + (k - 1), x0 + (k - 1)
        cy, cx = ty.clamp(0, H - 1), tx.clamp(0, W - 1)
        wy = _cubic_weight(fy, k) * (cy == ty)
        wx = _cubic_weight(fx, k) * (cx == tx)
        my = wy if my is None else my + wy
        mx = wx if mx is None else mx + wx
        rows.append((cy * W, wy))
        cols.append((cx, wx))
    src = imgs.reshape(N, C, Q)
    out = None
    for col, wx in cols:
        acc = None
        for row, wy in rows:
            idx = (row + col)[:, None, :].expand(N, C, Q)
            term = torch.gather(src, 2, idx) * wy[:, None, :]
            acc = term if acc is None else acc + term
        term = acc * wx[:, None, :]
        out = term if out is None else out + term
    mask = torch.clamp(my * mx, 0.0, 1.0)[:, None, :]
    res = out * mask + fill * (1.0 - mask)
    return torch.clamp(torch.round(res), 0.0, 255.0).reshape(N, C, H, W)


# ---------------------------------------------------------------------------
# pixel ops (torchvision uint8 semantics on the f32 0..255 grid), batched
# over [n, C, H, W] with one magnitude per frame
# ---------------------------------------------------------------------------


def _b(mag: torch.Tensor) -> torch.Tensor:
    return mag[:, None, None, None]


def _div(a: torch.Tensor, b) -> torch.Tensor:
    """a / b rounded as an f32 division: a scalar divisor becomes a 0-d
    tensor on a's device (filled there, no copy), since PyTorch multiplies
    by a scalar's reciprocal (on the CPU and the card) where the JAX
    package divides."""
    return a / (b if torch.is_tensor(b) else a.new_full((), b))


def _blend(a: torch.Tensor, b: torch.Tensor, factor) -> torch.Tensor:
    out = b + factor * (a - b)
    return torch.clamp(torch.trunc(out), 0.0, 255.0)  # uint8 casts truncate


def _grayscale(img: torch.Tensor) -> torch.Tensor:
    """[n, 1, H, W] luma, truncated. One channel is read three times so a
    grayscale frame gives the 3-channel result bit for bit (the weights
    sum to 0.9999, so this is not the identity: trunc(0.9999 v) != v for
    v >= 104)."""
    r = img[:, 0]
    g = img[:, 1] if img.shape[1] == 3 else r
    b = img[:, 2] if img.shape[1] == 3 else r
    return torch.trunc(0.2989 * r + 0.587 * g + 0.114 * b)[:, None]


def brightness(img, mag):
    return _blend(img, torch.zeros_like(img), 1.0 + _b(mag))


def color(img, mag):
    return _blend(img, _grayscale(img), 1.0 + _b(mag))


def contrast(img, mag):
    # PIL ImageEnhance.Contrast quantizes the gray mean half-up; the sum of
    # integer values is taken exactly
    H, W = img.shape[-2:]
    total = _grayscale(img).to(torch.int64).sum((2, 3), keepdim=True)
    mean = torch.floor(_div(total.float(), float(H * W)) + 0.5)
    return _blend(img, mean.expand(img.shape), 1.0 + _b(mag))


SHARPEN = ((1.0, 1.0, 1.0), (1.0, 5.0, 1.0), (1.0, 1.0, 1.0))


def sharpness(img, mag):
    """torchvision adjust_sharpness: the 3x3 smoothing kernel over interior
    pixels (the 1-pixel border stays), then a blend."""
    H, W = img.shape[-2:]
    blurred = None
    for dy, row in enumerate(SHARPEN):
        for dx, k in enumerate(row):
            term = img[:, :, dy:H - 2 + dy, dx:W - 2 + dx] * (k / 13.0)
            blurred = term if blurred is None else blurred + term
    result = img.clone()
    result[:, :, 1:-1, 1:-1] = torch.clamp(torch.round(blurred), 0.0, 255.0)
    return _blend(img, result, 1.0 + _b(mag))


def posterize(img, bits):
    keep = torch.pow(2.0, 8.0 - _b(bits))
    return torch.floor(img / keep) * keep


def solarize(img, threshold):
    return torch.where(img >= _b(threshold), 255.0 - img, img)


def autocontrast(img, _mag=None):
    lo = img.amin((2, 3), keepdim=True)
    hi = img.amax((2, 3), keepdim=True)
    scale = _div(torch.full_like(lo, 255.0), torch.where(hi > lo, hi - lo, 1.0))
    out = torch.trunc((img - lo) * scale)
    return torch.where(hi > lo, torch.clamp(out, 0.0, 255.0), img)


def equalize(img, _mag=None):
    """torchvision F.equalize: a LUT per channel from its cumulative
    histogram (exact integer counts)."""
    n, C, H, W = img.shape
    M = n * C
    flat = img.reshape(M, H * W).to(torch.int64)
    offset = torch.arange(M, device=img.device)[:, None] * 256
    # integer counts below 2^24 in f32: exact in any order; unlike
    # bincount, index_add_ needs no device -> host read of the largest bin
    hist = torch.zeros(M * 256, device=img.device).index_add_(
        0, (flat + offset).reshape(-1),
        torch.ones(flat.numel(), device=img.device)).reshape(M, 256)
    last_idx = 255 - torch.argmax((hist > 0).flip(1).to(torch.uint8), dim=1)
    last = hist.gather(1, last_idx[:, None])[:, 0]
    step = torch.floor(_div(hist.sum(1) - last, 255.0))
    cum = torch.cumsum(hist, 1)
    lut = torch.floor((cum + torch.floor(step / 2.0)[:, None])
                      / torch.where(step > 0, step, 1.0)[:, None])
    lut = torch.clamp(torch.cat([torch.zeros_like(lut[:, :1]), lut[:, :-1]],
                                1), 0.0, 255.0)
    out = lut.gather(1, flat).reshape(n, C, H, W)
    return torch.where((step > 0).reshape(n, C, 1, 1), out, img)


PIXEL_OPS = {6: brightness, 7: color, 8: contrast, 9: sharpness,
             10: posterize, 11: solarize, 12: autocontrast, 13: equalize}


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


def _host_ints(values: List[int], device: torch.device) -> torch.Tensor:
    """Host ints as an int64 tensor on `device`; to a card through pinned
    memory without waiting for the work queued there."""
    t = torch.tensor(values, dtype=torch.int64)
    if device.type == "cuda":
        t = t.pin_memory().to(device, non_blocking=True)
    return t


def _augment_step(flat: torch.Tensor, ops: Sequence[int], mag: torch.Tensor,
                  fill: float) -> torch.Tensor:
    """One RandAugment step over [N, C, H, W]: frame i gets op ops[i] (host
    ints) with magnitude mag[i]. The geometric frames share one warp, each
    pixel op runs on its frames; the groups' frame indices (and the
    geometric frames' ops) reach the device in one copy."""
    N, C, H, W = flat.shape
    groups = [([i for i, o in enumerate(ops) if o in GEOMETRIC], None)] + [
        ([i for i, o in enumerate(ops) if o == k], fn)
        for k, fn in PIXEL_OPS.items()]
    perm = [i for sel, _ in groups for i in sel]
    geo_ops = [ops[i] for i in groups[0][0]]
    dev_ints = _host_ints(perm + geo_ops, flat.device)
    out = flat.clone()
    start = 0
    for sel, fn in groups:
        if not sel:
            continue
        idx = dev_ints[start:start + len(sel)]
        start += len(sel)
        imgs, m = flat[idx], mag[idx]
        if fn is None:
            op = dev_ints[len(perm):]
            res = warp(imgs, _geo_matrices(op, m, H, W), fill)
        else:
            res = fn(imgs, m)
        out.index_copy_(0, idx, res)
    return out


def apply_one_op(img: torch.Tensor, op_idx: int, mag, fill: float = 255.0
                 ) -> torch.Tensor:
    """Op `op_idx` with magnitude `mag` on one [C, H, W] frame."""
    mag = torch.as_tensor(mag, dtype=torch.float32,
                          device=img.device).reshape(1)
    return _augment_step(img[None], [int(op_idx)], mag, fill)[0]


def apply_ops(frames: torch.Tensor, op_idx: torch.Tensor, mag: torch.Tensor,
              fill: float = 255.0) -> torch.Tensor:
    """RandAugment with given draws: [B, T, C, H, W] f32 frames (0..255),
    op_idx / mag [B, num_ops] (from `sample_ops`, or the JAX package's
    `_sample_ops`). Every view of a sample gets its sample's ops. The op
    indices are read on the host, so a caller with draws on the card can
    copy them over before it queues the frames' work."""
    B, T, C, H, W = frames.shape
    host = torch.as_tensor(op_idx).tolist()  # waits for device draws
    mag = torch.as_tensor(mag, device=frames.device).float()
    flat = frames.reshape(B * T, C, H, W)
    for i in range(len(host[0])):
        ops = [row[i] for row in host for _ in range(T)]
        per_view = mag[:, i, None].expand(B, T).reshape(B * T)
        flat = _augment_step(flat, ops, per_view, fill)
    return flat.reshape(B, T, C, H, W)


def randaugment(frames: torch.Tensor, generator: torch.Generator,
                num_ops: int = 2, fill: float = 255.0) -> torch.Tensor:
    """Per-sample RandAugment of [B, T, C, H, W] frames, drawn from
    `generator` (on the frames' device)."""
    B, _, _, H, W = frames.shape
    return apply_ops(frames, *sample_ops(generator, B, num_ops, H, W), fill)
