"""Fused-qkv multi-head attention forward.

Port of eventclip_tpu/ops/attention.py::fused_qkv_attention (forward only).
On a CUDA tensor it launches the hand-written kernel csrc/attention.cu (the
Hopper counterpart of the TPU kernel `_qkv_attention_forward`); on a CPU
tensor it takes `qkv_attention_plain`, the same arithmetic in plain PyTorch.
The backward kernel comes with training.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import kernels

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (16, 32, 64)


def _split_heads(qkv: torch.Tensor, heads: int):
    B, S, D3 = qkv.shape
    D = D3 // 3

    def split(t):
        return t.reshape(B, S, heads, D // heads).transpose(1, 2)

    return tuple(split(t) for t in qkv.split(D, dim=-1))


def qkv_attention_plain(qkv: torch.Tensor, heads: int,
                        mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[B, S, 3D] (+ f32 [S, S] additive mask) -> [B, S, D], in the TPU
    kernel's order: f32 scores scaled after the dot, full-row softmax, p
    rounded to the input dtype before p @ v, f32 accumulation."""
    B, S, D3 = qkv.shape
    D = D3 // 3
    scale = (D // heads) ** -0.5
    q, k, v = _split_heads(qkv, heads)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if mask is not None:
        s = s + mask.float()
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    p = (p / p.sum(-1, keepdim=True)).to(qkv.dtype)
    o = torch.matmul(p.float(), v.float()).to(qkv.dtype)
    return o.transpose(1, 2).reshape(B, S, D)


def _check(qkv: torch.Tensor, heads: int, mask: Optional[torch.Tensor]):
    if qkv.dim() != 3 or qkv.shape[-1] % 3:
        raise ValueError(f"expected qkv [B, S, 3D], got {tuple(qkv.shape)}")
    D = qkv.shape[-1] // 3
    if D % heads or D // heads not in _HEAD_DIMS:
        raise ValueError(f"head dim {D}/{heads} not in {_HEAD_DIMS}")
    if qkv.dtype not in _DTYPE_CODE:
        raise TypeError(f"qkv dtype {qkv.dtype} not in {list(_DTYPE_CODE)}")
    if not qkv.is_contiguous():
        raise ValueError("qkv must be contiguous")
    if mask is not None:
        S = qkv.shape[1]
        if (mask.shape != (S, S) or mask.dtype != torch.float32
                or mask.device != qkv.device or not mask.is_contiguous()):
            raise ValueError(
                f"mask must be a contiguous float32 [{S}, {S}] tensor on "
                f"{qkv.device}, got {mask.dtype} {tuple(mask.shape)} on "
                f"{mask.device}")


def fused_qkv_attention(qkv: torch.Tensor, heads: int,
                        mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[B, S, 3D] fused qkv (+ optional f32 [S, S] mask) -> [B, S, D].

    CUDA tensors run the kernel (or raise); CPU tensors run the plain
    version."""
    _check(qkv, heads, mask)
    if qkv.device.type == "cpu":
        return qkv_attention_plain(qkv, heads, mask)
    if qkv.device.type != "cuda":
        raise ValueError(f"unsupported device {qkv.device}")
    B, S, D3 = qkv.shape
    D = D3 // 3
    dh = D // heads
    out = torch.empty((B, S, D), dtype=qkv.dtype, device=qkv.device)
    lib = kernels.library("attention")
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        rc = lib.qkv_attention_fwd(
            qkv.data_ptr(), None if mask is None else mask.data_ptr(),
            out.data_ptr(), B, S, heads, dh, _DTYPE_CODE[qkv.dtype],
            dh ** -0.5, stream)
    kernels.check(lib, rc, "qkv_attention_fwd")
    kernels.LAUNCHES["qkv_attention"] += 1
    return out
