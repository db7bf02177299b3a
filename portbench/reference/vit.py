"""Reference CLIP ViT image tower, in plain PyTorch float32.

`clip/model.py::VisionTransformer` of openai/CLIP (arXiv 2103.00020), on
a state dict in OpenAI's names (`conv1.weight`, `class_embedding`,
`positional_embedding`, `ln_pre`, `transformer.resblocks.<i>.{ln_1,
attn.in_proj_weight, attn.in_proj_bias, attn.out_proj, ln_2, mlp.c_fc,
mlp.c_proj}`, `ln_post`, `proj`): a stride-`patch` convolution without
bias, the class token, learned positions, pre-norm residual blocks of
multi-head attention (softmax(q k^T / sqrt(dh)) v) and a QuickGELU MLP,
the class token's final norm, the projection. Layer norms use eps 1e-5.
Matrix products run in float32 with TF32 off (the caller's switch).

`rnd` (default: none) rounds every tensor that passes between two
operations, as a mixed-precision model stores it: the weights at use, the
residual stream, each norm's and each product's output, the attention
probabilities before they weigh the values, the MLP's activation. With
`rnd=to_bf16` this is the tower in the configuration's bfloat16 storage
with float32 arithmetic inside each operation.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch
import torch.nn.functional as F


def exact(t: torch.Tensor) -> torch.Tensor:
    return t


def to_bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float()


def _ln(x, w: Dict[str, torch.Tensor], name: str) -> torch.Tensor:
    return F.layer_norm(x, x.shape[-1:], w[name + ".weight"],
                        w[name + ".bias"], 1e-5)


def block(x: torch.Tensor, w: Dict[str, torch.Tensor], pre: str,
          heads: int, rnd: Callable = exact) -> torch.Tensor:
    B, S, D = x.shape
    dh = D // heads

    def lin(h, name):
        return rnd(h @ rnd(w[pre + name + ".weight"]).T
                   + w[pre + name + ".bias"])

    h = rnd(_ln(x, w, pre + "ln_1"))
    qkv = rnd(h @ rnd(w[pre + "attn.in_proj_weight"]).T
              + w[pre + "attn.in_proj_bias"])
    q, k, v = (t.reshape(B, S, heads, dh).transpose(1, 2)
               for t in qkv.split(D, dim=-1))
    p = rnd(torch.softmax((q @ k.transpose(-1, -2)) / dh ** 0.5, dim=-1))
    o = rnd((p @ v).transpose(1, 2).reshape(B, S, D))
    x = rnd(x + lin(o, "attn.out_proj"))
    h = rnd(_ln(x, w, pre + "ln_2"))
    h = lin(h, "mlp.c_fc")
    h = rnd(h * torch.sigmoid(1.702 * h))
    return rnd(x + lin(h, "mlp.c_proj"))


def encode(images: torch.Tensor, w: Dict[str, torch.Tensor], layers: int,
           heads: int, rnd: Callable = exact) -> torch.Tensor:
    """[B, 3, S, S] CLIP-normalised images -> [B, embed] features."""
    conv = rnd(w["conv1.weight"])
    x = F.conv2d(rnd(images), conv, stride=conv.shape[-1])  # [B, D, g, g]
    x = rnd(x.flatten(2).transpose(1, 2))
    cls = w["class_embedding"].expand(x.shape[0], 1, -1)
    x = rnd(torch.cat([cls, x], dim=1) + w["positional_embedding"])
    x = rnd(_ln(x, w, "ln_pre"))
    for i in range(layers):
        x = block(x, w, f"transformer.resblocks.{i}.", heads, rnd)
    return rnd(_ln(x[:, 0], w, "ln_post")) @ rnd(w["proj"])
