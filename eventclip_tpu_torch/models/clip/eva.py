"""The EVA02-CLIP image tower (EVA-CLIP's `eva_vit_model.py`,
github.com/baaivision/EVA; Sun et al., arXiv:2303.15389; Fang et al.,
arXiv:2303.11331), on the port's kernels.

A patch embedding with bias, the class token, learned positions (no
`ln_pre`), then pre-norm blocks:

- attention: one product for q/k/v (`wqkv` [3D, D]; EVA has no k bias,
  stored here as zeros in `bqkv`), EVA's 2-D rotary positions on the q and
  k of the patch tokens in place (`eventclip::rope_qkv`, ops/rope.py), K2
  (`eventclip::qkv_attention`), `inner_attn_ln` on the heads' output, the
  out product;
- MLP: SwiGLU, `ffn_ln(SiLU(x W1^T + b1) * (x W2^T + b2)) W3^T + b3`, with
  W1 and W2 fused into one product (`w12` [2 Hs, D]: W1's rows, then
  W2's) and the hidden width `mlp_hidden` stored as `mlp_stored` (a
  multiple of 8, which D1 needs: 2730 -> 2736), its pad rows of W1 / W2,
  pad entries of b1 / b2 and pad columns of W3 zero; `ffn_ln` normalises
  the `mlp_hidden` real columns only and the pad columns are written as 0
  (`swiglu`, inside a `record_function("swiglu")` range: one pass of the
  op `eventclip::swiglu_ln`, ops/swiglu.py, S1 csrc/swiglu.cu on the card);

then the class token's final norm and `head` (with bias). Layer norms
use eps 1e-6. Every product goes through `dense` (D1 on the card for
every block product; the K = 588 patch embedding keeps the library GEMM),
the head is the f32 product of the rounded operands as the ViT's
projection is.

Serving only: LoRA, remat, token pruning, tensor parallelism, int8 and a
recorded gradient are refused (`refuse`). The rotary tables are made once
a tower and device, at its first forward.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.profiler import record_function

from ...ops.attention import fused_qkv_attention
from ...ops import rope as _rope
from ...ops.rope import rope_qkv
from ...ops.swiglu import swiglu_ln
from .config import EVAVisionConfig
from .layers import _normal_, _param, dense, layer_norm


def refuse(what: str, cfg: EVAVisionConfig) -> ValueError:
    return ValueError(f"{what} is not supported for the EVA02 image tower "
                      f"(width {cfg.width}, {cfg.layers} layers): it is "
                      "served only, in bf16 on the card (the rotary "
                      "kernel's dtype) or f32 on the CPU")


# the up-front options this tower refuses (models/clip/model.py's
# `refuse_option` asks); LoRA at init is a TypeError, as a ResNet's is
REFUSES = dict.fromkeys(("token pruning", "int8", "export", "f32 on the card"),
                        refuse)
REFUSES["LoRA"] = lambda what, cfg: TypeError(*refuse(what, cfg).args)


class EVABlock(nn.Module):
    def __init__(self, cfg: EVAVisionConfig, device=None):
        super().__init__()
        D, H, Hs = cfg.width, cfg.mlp_hidden, cfg.mlp_stored
        self.heads = cfg.heads
        self.norm1 = nn.LayerNorm(D, eps=cfg.eps, device=device)
        self.wqkv = _param(3 * D, D, device=device)
        self.bqkv = _param(3 * D, zeros=True, device=device)
        self.inner_attn_ln = nn.LayerNorm(D, eps=cfg.eps, device=device)
        self.wo = _param(D, D, device=device)
        self.bo = _param(D, zeros=True, device=device)
        self.norm2 = nn.LayerNorm(D, eps=cfg.eps, device=device)
        self.w12 = _param(2 * Hs, D, device=device)
        self.b12 = _param(2 * Hs, zeros=True, device=device)
        self.ffn_ln = nn.LayerNorm(H, eps=cfg.eps, device=device)
        self.w3 = _param(D, Hs, device=device)
        self.b3 = _param(D, zeros=True, device=device)


class EVAVisionTower(nn.Module):
    def __init__(self, cfg: EVAVisionConfig, device=None):
        super().__init__()
        self.cfg = cfg
        D = cfg.width
        self.patch_embed = _param(D, 3 * cfg.patch_size ** 2, device=device)
        self.patch_bias = _param(D, zeros=True, device=device)
        self.class_embedding = _param(D, device=device)
        self.positional_embedding = _param(cfg.seq_len, D, device=device)
        self.blocks = nn.ModuleList(
            EVABlock(cfg, device=device) for _ in range(cfg.layers))
        self.norm = nn.LayerNorm(D, eps=cfg.eps, device=device)
        self.head = _param(cfg.output_dim, D, device=device)
        self.head_bias = _param(cfg.output_dim, zeros=True, device=device)
        self._rope = None

    def rope(self, device) -> tuple:
        """(cos, sin) f32 [grid², head dim] on `device`, made once."""
        if self._rope is None or self._rope[0].device != device:
            self._rope = rope_tables(self.cfg, device)
        return self._rope


def rope_tables(cfg: EVAVisionConfig, device) -> tuple:
    return _rope.rope_tables(cfg.grid, cfg.width // cfg.heads,
                             cfg.rope_theta, cfg.pt_hw_seq_len, device)


def attention(blk: EVABlock, h: torch.Tensor, rope: tuple) -> torch.Tensor:
    qkv = dense(h, blk.wqkv, blk.bqkv)  # [B, S, 3D]
    rope_qkv(qkv, *rope, blk.heads)
    o = fused_qkv_attention(qkv, blk.heads)
    return dense(layer_norm(o, blk.inner_attn_ln), blk.wo, blk.bo)


def swiglu(h12: torch.Tensor, ffn_ln: nn.LayerNorm) -> torch.Tensor:
    """[..., 2 Hs] gate and value -> [..., Hs]: SiLU(gate) * value over the
    real columns in f32, rounded once, `ffn_ln` over them, the pad
    columns 0."""
    return swiglu_ln(h12, ffn_ln.weight, ffn_ln.bias, ffn_ln.eps)


def mlp(blk: EVABlock, h: torch.Tensor) -> torch.Tensor:
    h12 = dense(h, blk.w12, blk.b12)
    with record_function("swiglu"):
        h = swiglu(h12, blk.ffn_ln)
    return dense(h, blk.w3, blk.b3)


def block(blk: EVABlock, x: torch.Tensor, rope: tuple) -> torch.Tensor:
    x = x + attention(blk, layer_norm(x, blk.norm1), rope)
    return x + mlp(blk, layer_norm(x, blk.norm2))


def encode_image_eva(visual: EVAVisionTower, images: torch.Tensor, *,
                     dtype: torch.dtype = torch.float32, lora=None,
                     remat: bool = False, keep_tokens: Optional[int] = None,
                     tp=None) -> torch.Tensor:
    """[B, 3, H, W] CLIP-normalized images -> [B, output_dim] f32
    features."""
    cfg = visual.cfg
    ps, g, D = cfg.patch_size, cfg.grid, cfg.width
    for what, on in (("training (a recorded gradient)",
                      torch.is_grad_enabled()),
                     ("LoRA", lora is not None), ("remat", remat),
                     ("token pruning", keep_tokens is not None
                      and keep_tokens < g * g),
                     ("tensor parallelism", tp is not None)):
        if on:
            raise refuse(what, cfg)
    B = images.shape[0]
    x = images.to(dtype)
    x = x.reshape(B, 3, g, ps, g, ps).permute(0, 2, 4, 1, 3, 5)
    x = x.reshape(B, g * g, 3 * ps * ps)
    pos = visual.positional_embedding.to(dtype)
    x = dense(x, visual.patch_embed, visual.patch_bias) + pos[1:]
    cls = (visual.class_embedding.to(dtype) + pos[0]).expand(B, 1, D)
    x = torch.cat([cls, x], dim=1)
    rope = visual.rope(x.device)
    for blk in visual.blocks:
        x = block(blk, x, rope)
    x = layer_norm(x[:, 0], visual.norm)
    return (torch.matmul(x.float(), visual.head.to(dtype).float().t())
            + visual.head_bias.float())


@torch.no_grad()
def init_eva_visual_(visual: EVAVisionTower,
                     generator: torch.Generator) -> None:
    """Random weights in place, OpenAI's scheme at EVA's shapes (biases
    zero, norms identity), the stored hidden's pad entries zero."""
    cfg = visual.cfg
    D, H, L = cfg.width, cfg.mlp_hidden, cfg.layers
    for p in (visual.patch_embed, visual.class_embedding,
              visual.positional_embedding, visual.head):
        _normal_(p, D ** -0.5, generator)
    for blk in visual.blocks:
        _normal_(blk.wqkv, D ** -0.5, generator)
        _normal_(blk.wo, (D ** -0.5) * ((2 * L) ** -0.5), generator)
        _normal_(blk.w12, (2 * D) ** -0.5, generator)
        _normal_(blk.w3, (D ** -0.5) * ((2 * L) ** -0.5), generator)
        pad_hidden_(blk, H)


@torch.no_grad()
def pad_hidden_(blk: EVABlock, hidden: int) -> None:
    """Zero the stored hidden's pad: W1 / W2 rows and b1 / b2 entries past
    `hidden`, W3 columns past it."""
    Hs = blk.w3.shape[1]
    for half in (blk.w12[:Hs], blk.w12[Hs:]):
        half[hidden:] = 0
    for half in (blk.b12[:Hs], blk.b12[Hs:]):
        half[hidden:] = 0
    blk.w3[:, hidden:] = 0
