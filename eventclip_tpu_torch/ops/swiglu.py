"""EVA02's SwiGLU glue, SiLU(gate) * value and `ffn_ln`, in one pass
(csrc/swiglu.cu, S1).

Between the MLP's fused W1/W2 product and W3 (models/clip/eva.py), `h12`
`[..., 2 Hs]` holds the gate in columns `[0, H)` and the value in `[Hs, Hs +
H)`, where Hs is the stored hidden width and H <= Hs the real one (the
length of `ffn_ln`'s weight). The result `[..., Hs]` is

    p = round(SiLU(gate) * value)           in f32, rounded to h12's dtype
    y = round(layer_norm(p) * weight + bias)  over the H real columns, f32

with columns `[H, Hs)` 0; whatever the pad columns of `h12` hold never
enters the statistics.

`swiglu_ln(h12, weight, bias, eps)` goes through the `torch.library` op
`eventclip::swiglu_ln` (ops/custom_ops.py): on CUDA tensors the
hand-written kernel, which counts `kernels.LAUNCHES["swiglu_ln"]`, on CPU
tensors `swiglu_plain`. Both round at the same points; the kernel sums the
statistics in another order.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import kernels
from .attention import _on_device, _stream


def swiglu_plain(h12: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                 eps: float) -> torch.Tensor:
    """The plain version of the kernel."""
    Hs = h12.shape[-1] // 2
    H = weight.shape[0]
    h = (F.silu(h12[..., :H].float()) * h12[..., Hs:Hs + H].float()
         ).to(h12.dtype)
    y = F.layer_norm(h.float(), (H,), weight.float(), bias.float(), eps)
    return F.pad(y.to(h.dtype), (0, Hs - H))


def launch_swiglu_ln(h12: torch.Tensor, weight: torch.Tensor,
                     bias: torch.Tensor, eps: float) -> torch.Tensor:
    """The CUDA implementation of `eventclip::swiglu_ln` on checked
    tensors."""
    Hs = h12.shape[-1] // 2
    out = h12.new_empty((*h12.shape[:-1], Hs))
    M = h12.numel() // (2 * Hs)
    if M == 0:
        return out
    lib = kernels.library("swiglu")
    with _on_device(h12):
        rc = lib.swiglu_ln(h12.data_ptr(), weight.data_ptr(),
                           bias.data_ptr(), out.data_ptr(), M,
                           weight.shape[0], Hs, eps, _stream(h12))
    kernels.check(lib, rc, "swiglu_ln")
    kernels.LAUNCHES["swiglu_ln"] += 1
    return out


def _check(h12: torch.Tensor, weight: torch.Tensor,
           bias: torch.Tensor) -> None:
    if h12.dim() < 1 or h12.shape[-1] % 2:
        raise ValueError(f"expected h12 [..., 2 Hs], got {tuple(h12.shape)}")
    Hs = h12.shape[-1] // 2
    H = weight.shape[0] if weight.dim() == 1 else -1
    if not 0 < H <= Hs:
        raise ValueError(f"the norm's weight must be [H] with 0 < H <= Hs = "
                         f"{Hs}, got {tuple(weight.shape)}")
    for name, t in (("weight", weight), ("bias", bias)):
        if (t.shape != (H,) or t.dtype != torch.float32
                or t.device != h12.device or not t.is_contiguous()
                or (t.is_cuda and t.data_ptr() % 16)):
            raise ValueError(f"the norm's {name} must be contiguous f32 [{H}]"
                             f" on {h12.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if h12.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"swiglu_ln takes bf16 or f32 h12, got {h12.dtype}")
    if not h12.is_cuda:
        return
    if h12.dtype != torch.bfloat16:
        raise TypeError("the CUDA kernel takes bf16 h12")
    if Hs % 8:
        raise ValueError(f"the CUDA kernel takes a stored width Hs that is a "
                         f"multiple of 8, got {Hs}")
    if not h12.is_contiguous() or h12.data_ptr() % 16:
        raise ValueError("h12 must be contiguous from a 16-byte-aligned base")


def swiglu_ln(h12: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
              eps: float) -> torch.Tensor:
    """`h12` [..., 2 Hs] -> [..., Hs] through `eventclip::swiglu_ln` (see
    the module docstring); `weight`, `bias` the f32 [H] of the norm."""
    _check(h12, weight, bias)
    return torch.ops.eventclip.swiglu_ln(h12, weight, bias, eps)
