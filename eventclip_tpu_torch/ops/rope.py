"""2-D rotary positions on the fused q/k/v, in place (csrc/rope.cu).

EVA02's rotary embedding (EVA-CLIP `rope.py`, `VisionRotaryEmbeddingFast`
and `rotate_half`) on the fused `[B, S, 3D]` q/k/v that `dense` writes
and K2 (`eventclip::qkv_attention`) reads: tokens 1 ... S-1 (the patches,
in raster order) of the q and k thirds, each head's dimensions as
interleaved pairs (2j, 2j+1) -> (x0 c - x1 s, x1 c + x0 s). The class
token and the v third are left as they are.

`rope_tables` makes the f32 cos and sin tables `[S-1, dh]`: a head's first
dh/2 dimensions turn with the patch's row, the last dh/2 with its column,
at frequencies theta^(-2j/(dh/2)), each repeated for its pair; positions
are interpolated to `pt_seq_len` (EVA's `intp_freq`: `t = arange(g) / g *
pt`).

`rope_qkv(qkv, cos, sin, heads)` goes through the `torch.library` op
`eventclip::rope_qkv` (ops/custom_ops.py), which writes `qkv` in place:
on CUDA tensors the hand-written kernel, on CPU tensors `rope_qkv_plain`.
Both read the q or k value as f32, rotate it with the f32 tables (each
product and the sum rounded apart, no fused multiply-add) and round once
to the tensor's dtype, the order of EVA's `.type_as(v)` after the
rotation.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .. import kernels
from .attention import _on_device, _stream


def rope_tables(grid: int, head_dim: int, theta: float, pt_seq_len: int,
                device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin), f32 [grid², head_dim] (see the module docstring)."""
    dim = head_dim // 2
    freqs = 1.0 / theta ** (torch.arange(0, dim, 2)[: dim // 2].float()
                            / dim)
    t = torch.arange(grid).float() / grid * pt_seq_len
    f = (t[:, None] * freqs[None, :]).repeat_interleave(2, dim=-1)
    f = torch.cat([f[:, None, :].expand(grid, grid, dim),
                   f[None, :, :].expand(grid, grid, dim)], dim=-1)
    f = f.reshape(grid * grid, head_dim)
    return f.cos().to(device), f.sin().to(device)


def rope_qkv_plain(qkv: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                   heads: int) -> None:
    """The plain version of the kernel, in place."""
    B, S, D3 = qkv.shape
    D = D3 // 3
    x = qkv[:, 1:, :2 * D].float().reshape(B, S - 1, 2, heads, -1, 2)
    c = cos.reshape(S - 1, 1, 1, -1, 2)
    s = sin.reshape(S - 1, 1, 1, -1, 2)
    x0, x1 = x[..., 0], x[..., 1]
    y = torch.stack([x0 * c[..., 0] - x1 * s[..., 0],
                     x1 * c[..., 1] + x0 * s[..., 1]], dim=-1)
    qkv[:, 1:, :2 * D] = y.reshape(B, S - 1, 2 * D).to(qkv.dtype)


def launch_rope_qkv(qkv: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                    heads: int) -> None:
    """The CUDA implementation of `eventclip::rope_qkv` on checked
    tensors."""
    B, S, D3 = qkv.shape
    if B == 0 or S < 2:
        return
    lib = kernels.library("rope")
    with _on_device(qkv):
        rc = lib.rope_qkv(qkv.data_ptr(), cos.data_ptr(), sin.data_ptr(),
                          B, S, D3 // 3, heads, _stream(qkv))
    kernels.check(lib, rc, "rope_qkv")
    kernels.LAUNCHES["rope_qkv"] += 1


def _check(qkv: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
           heads: int) -> None:
    if qkv.dim() != 3 or qkv.shape[-1] % 3:
        raise ValueError(f"expected qkv [B, S, 3D], got {tuple(qkv.shape)}")
    B, S, D3 = qkv.shape
    D = D3 // 3
    if D % heads or (D // heads) % 8:
        raise ValueError(f"width {D} over {heads} heads: the head dim must "
                         "be a multiple of 8")
    if qkv.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"rope_qkv takes bf16 or f32 q/k/v, got {qkv.dtype}")
    if qkv.dtype != torch.bfloat16 and qkv.is_cuda:
        raise TypeError("the CUDA kernel takes bf16 q/k/v")
    if not qkv.is_contiguous() or (qkv.is_cuda and qkv.data_ptr() % 16):
        raise ValueError("qkv must be contiguous from a 16-byte-aligned "
                         "base")
    for t in (cos, sin):
        if (t.shape != (S - 1, D // heads) or t.dtype != torch.float32
                or not t.is_contiguous() or t.device != qkv.device
                or (t.is_cuda and t.data_ptr() % 16)):
            raise ValueError(f"the tables must be contiguous f32 "
                             f"[{S - 1}, {D // heads}] on {qkv.device}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")


def rope_qkv(qkv: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
             heads: int) -> None:
    """Rotate the q and k of tokens 1 ... S-1 of `qkv` [B, S, 3D] in place
    through `eventclip::rope_qkv`."""
    _check(qkv, cos, sin, heads)
    torch.ops.eventclip.rope_qkv(qkv, cos, sin, heads)
