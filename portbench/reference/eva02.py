"""Reference EVA02-CLIP towers, in plain PyTorch float32.

The image tower of EVA-CLIP's `eva_vit_model.py` (github.com/baaivision/EVA,
`EVA02-CLIP-L-14-336.json`; arXiv:2303.15389) with the rotary positions of
its `rope.py` (`VisionRotaryEmbeddingFast`, `rotate_half`), written from
their equations, on a state dict in EVA-CLIP's `visual.*` names without the
prefix: `patch_embed.proj` (a stride-`patch` convolution with bias),
`cls_token`, `pos_embed`; per block `blocks.<i>.{norm1, attn.q_proj.weight,
attn.k_proj.weight, attn.v_proj.weight, attn.q_bias, attn.v_bias,
attn.inner_attn_ln, attn.proj, norm2, mlp.w1, mlp.w2, mlp.ffn_ln,
mlp.w3}`; then `norm` and `head`. A block is pre-norm:

- q = x Wq^T + bq, k = x Wk^T, v = x Wv^T + bv; the patch tokens' q and k
  rotated, t cos + rotate_half(t) sin, where a head's first half turns
  with the patch's row and its second half with its column, at
  frequencies theta^(-2j/(dh/2)) repeated for each interleaved pair, and
  positions interpolated, t = arange(g) / g * pt_hw_seq_len; the class
  token is not rotated;
- softmax(q k^T dh^-0.5) v, `inner_attn_ln`, the out projection;
- SwiGLU: SiLU(x W1^T + b1) * (x W2^T + b2), `ffn_ln`, W3 with bias.

The class token's final `norm`, then `head` with bias. Layer norms use eps
1e-6; the hidden width is the checkpoint's (2730 at L/14), unpadded.
Departures from EVA's code: the attention scale multiplies the scores
after q k^T, not q before it (the same at dh = 64, a power of two); the
rotary tables are computed from the configuration, not read from the
`rope.freqs_*` buffers; dropout, patch dropout and xformers' kernel are
left out (inference).

`encode_text` is EVA-CLIP's text tower for these models: OpenAI's text
transformer (names of OpenAI's state dict: `token_embedding.weight`,
`positional_embedding`, `transformer.resblocks.<i>.*`, `ln_final`,
`text_projection`; causal mask; eps 1e-5) with exact GELU in its MLP.

`rnd` (default: none) rounds every tensor that passes between two
operations, as `vit.py` does, and besides after the rotation, after each
sub-norm (`inner_attn_ln`, `ffn_ln`) and after SiLU(gate) * value: with
`rnd=vit.to_bf16` the tower in bfloat16 storage. `stream_probs` classifies
raw event streams as `zero_shot.py` does, through this tower. Matrix
products run in float32 with TF32 off (`zero_shot.tf32_off`).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from . import frames, vit, windows, zero_shot

exact = vit.exact
to_bf16 = vit.to_bf16


def _ln(x, w: Dict[str, torch.Tensor], name: str, eps: float):
    return F.layer_norm(x, x.shape[-1:], w[name + ".weight"],
                        w[name + ".bias"], eps)


def rope_tables(grid: int, head_dim: int, theta: float = 10000.0,
                pt_seq_len: int = 16, device=None):
    """(cos, sin) [grid², head_dim] of `VisionRotaryEmbeddingFast` with
    dim = head_dim / 2, ft_seq_len = grid (`intp_freq`)."""
    dim = head_dim // 2
    freqs = 1.0 / (theta ** (torch.arange(0, dim, 2)[:dim // 2].float()
                             / dim))
    t = torch.arange(grid) / grid * pt_seq_len
    f = t[:, None] * freqs[None, :]
    f = f[..., None].expand(grid, dim // 2, 2).reshape(grid, dim)
    f = torch.cat([f[:, None, :].expand(grid, grid, dim),
                   f[None, :, :].expand(grid, grid, dim)], dim=-1)
    f = f.reshape(-1, head_dim)
    return f.cos().to(device), f.sin().to(device)


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    x = x.reshape(*x.shape[:-1], -1, 2)
    x1, x2 = x.unbind(-1)
    return torch.stack((-x2, x1), dim=-1).reshape(*x.shape[:-2], -1)


def _rotate(t, cos, sin, rnd):
    rot = rnd(t[:, :, 1:] * cos + rotate_half(t[:, :, 1:]) * sin)
    return torch.cat([t[:, :, :1], rot], dim=2)


def block(x: torch.Tensor, w: Dict[str, torch.Tensor], pre: str,
          heads: int, rope, eps: float, rnd: Callable = exact
          ) -> torch.Tensor:
    B, S, D = x.shape
    dh = D // heads

    def lin(h, name, bias=None):
        b = w[pre + name + ".bias"] if bias is None else bias
        return rnd(h @ rnd(w[pre + name + ".weight"]).T + b)

    h = rnd(_ln(x, w, pre + "norm1", eps))
    q = lin(h, "attn.q_proj", w[pre + "attn.q_bias"])
    k = lin(h, "attn.k_proj", 0.0)
    v = lin(h, "attn.v_proj", w[pre + "attn.v_bias"])
    q, k, v = (t.reshape(B, S, heads, dh).transpose(1, 2) for t in (q, k, v))
    q, k = (_rotate(t, *rope, rnd) for t in (q, k))
    p = rnd(torch.softmax((q @ k.transpose(-1, -2)) * dh ** -0.5, dim=-1))
    o = rnd((p @ v).transpose(1, 2).reshape(B, S, D))
    o = rnd(_ln(o, w, pre + "attn.inner_attn_ln", eps))
    x = rnd(x + lin(o, "attn.proj"))
    h = rnd(_ln(x, w, pre + "norm2", eps))
    h = rnd(F.silu(lin(h, "mlp.w1")) * lin(h, "mlp.w2"))
    h = rnd(_ln(h, w, pre + "mlp.ffn_ln", eps))
    return rnd(x + lin(h, "mlp.w3"))


def encode(images: torch.Tensor, w: Dict[str, torch.Tensor],
           tower: Dict[str, Any], rnd: Callable = exact) -> torch.Tensor:
    """[B, 3, S, S] CLIP-normalised images -> [B, embed] features.
    `tower`: the configuration's `vision` block (layers, heads,
    patch_size, image_size, rope_theta, pt_hw_seq_len, eps)."""
    heads, eps = tower["heads"], tower["eps"]
    conv = rnd(w["patch_embed.proj.weight"])
    D, ps = conv.shape[0], conv.shape[-1]
    x = F.conv2d(rnd(images), conv, w["patch_embed.proj.bias"], stride=ps)
    grid = x.shape[-1]
    x = rnd(x.flatten(2).transpose(1, 2))
    cls = w["cls_token"].reshape(1, 1, D).expand(x.shape[0], 1, D)
    x = rnd(torch.cat([cls, x], dim=1) + w["pos_embed"].reshape(-1, D))
    rope = rope_tables(grid, D // heads, tower["rope_theta"],
                       tower["pt_hw_seq_len"], x.device)
    for i in range(tower["layers"]):
        x = block(x, w, f"blocks.{i}.", heads, rope, eps, rnd)
    x = rnd(_ln(x[:, 0], w, "norm", eps))
    return x @ rnd(w["head.weight"]).T + w["head.bias"]


def encode_text(tokens: torch.Tensor, w: Dict[str, torch.Tensor],
                heads: int, rnd: Callable = exact) -> torch.Tensor:
    """[B, T] token ids (the EOT the highest) -> [B, embed] features of
    the OpenAI-shaped text tower with exact GELU."""
    B, T = tokens.shape
    x = rnd(w["token_embedding.weight"][tokens]
            + w["positional_embedding"][:T])
    mask = torch.full((T, T), float("-inf"), device=x.device).triu(1)
    D = x.shape[-1]
    dh = D // heads
    layers = len({k.split(".")[2] for k in w
                  if k.startswith("transformer.resblocks.")})
    for i in range(layers):
        pre = f"transformer.resblocks.{i}."

        def lin(h, name):
            return rnd(h @ rnd(w[pre + name + ".weight"]).T
                       + w[pre + name + ".bias"])

        h = rnd(F.layer_norm(x, (D,), w[pre + "ln_1.weight"],
                             w[pre + "ln_1.bias"], 1e-5))
        qkv = rnd(h @ rnd(w[pre + "attn.in_proj_weight"]).T
                  + w[pre + "attn.in_proj_bias"])
        q, k, v = (t.reshape(B, T, heads, dh).transpose(1, 2)
                   for t in qkv.split(D, dim=-1))
        p = rnd(torch.softmax((q @ k.transpose(-1, -2)) * dh ** -0.5 + mask,
                              dim=-1))
        o = rnd((p @ v).transpose(1, 2).reshape(B, T, D))
        x = rnd(x + lin(o, "attn.out_proj"))
        h = rnd(F.layer_norm(x, (D,), w[pre + "ln_2.weight"],
                             w[pre + "ln_2.bias"], 1e-5))
        h = rnd(F.gelu(lin(h, "mlp.c_fc")))
        x = rnd(x + lin(h, "mlp.c_proj"))
    x = rnd(F.layer_norm(x, (D,), w["ln_final.weight"], w["ln_final.bias"],
                         1e-5))
    x = x[torch.arange(B, device=x.device), tokens.argmax(-1)]
    return x @ rnd(w["text_projection"])


@torch.no_grad()
def stream_probs(streams: List[np.ndarray], weights: Dict[str, torch.Tensor],
                 text_feats: torch.Tensor, geo: Dict[str, Any],
                 block: int = 32, rnd=exact) -> np.ndarray:
    """[n] raw streams -> [n, n_classes] float32 probabilities, as
    `zero_shot.stream_probs` (the same windows, frames and head) through
    this tower. geo: height, width, window, views, image_size,
    logit_scale, thresh, grey, and `tower` (see `encode`)."""
    zero_shot.tf32_off()
    device = text_feats.device
    views, owner = [], []
    for i, s in enumerate(streams):
        w = windows.stream_windows(s, geo["height"], geo["width"],
                                   geo["window"], geo["views"])
        views += w
        owner += [i] * len(w)
    feats = []
    for a in range(0, len(views), block):
        hist = frames.histograms(views[a:a + block], geo["height"],
                                 geo["width"], device)
        img = frames.frames(hist, geo["thresh"], geo["grey"])
        x = frames.clip_inputs(img, geo["image_size"])
        feats.append(encode(x, weights, geo["tower"], rnd))
    logits = geo["logit_scale"] * torch.cat(feats) @ text_feats.T
    p = torch.softmax(logits, dim=-1)
    owner_t = torch.tensor(owner, device=device)
    out = torch.zeros((len(streams), p.shape[-1]), device=device)
    out.index_add_(0, owner_t, p)
    counts = torch.bincount(owner_t, minlength=len(streams)).float()
    return (out / counts[:, None]).cpu().numpy()
