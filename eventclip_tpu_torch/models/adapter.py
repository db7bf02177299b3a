"""Feature adapters for few-shot EventCLIP (FSCLIP).

Port of eventclip_tpu/models/adapter.py (reference models/adapter.py):

- identity: pass-through;
- trans: in_proj -> a pre-norm transformer encoder (`num_layers` layers,
  multi-head self attention over the views with a key-padding mask, ReLU
  MLP, dropout at four places) -> out_proj -> the residual blend
  out = res * in + (1 - res) * new.

The parameters keep the JAX package's names so that
models/clip/convert.py::jax_path maps each onto its JAX tree path
(`adapter/in_proj/w`, `adapter/blocks/attn/wqkv`, `adapter/blocks/ln_1/
scale`, ...). Only the layer norms own a `weight` (jax_path renames it
`scale`), so the projections are plain parameters, not `nn.Linear`.

The attention runs over T = 2-10 views, with a per-sample padding mask: it
is plain PyTorch, as it is an einsum (not a Pallas kernel) in the JAX
package. Dropout draws from an explicit `torch.Generator`, and only when
`train=True` and a generator is given (the JAX package's `rng is None ->
train=False` rule).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from .clip.model import dense, layer_norm


@dataclasses.dataclass(frozen=True)
class AdapterConfig:
    adapter_type: str = "identity"  # 'identity' | 'trans'
    in_dim: int = 512
    d_model: int = 256
    num_heads: int = 4
    ffn_dim: int = 1024
    num_layers: int = 2
    residual: float = 0.0  # torch bool residual maps to 0.5 (True) / 0.0
    dropout: float = 0.1  # torch TransformerEncoderLayer default

    @staticmethod
    def residual_value(residual) -> float:
        if isinstance(residual, bool):
            return 0.5 if residual else 0.0
        assert 0.0 <= float(residual) <= 1.0
        return float(residual)


def _param(*shape, device=None) -> nn.Parameter:
    return nn.Parameter(torch.zeros(*shape, device=device))


class Projection(nn.Module):
    """w [out, in], b [out] (JAX `{'w', 'b'}`)."""

    def __init__(self, out_dim: int, in_dim: int, device=None):
        super().__init__()
        self.w = _param(out_dim, in_dim, device=device)
        self.b = _param(out_dim, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return dense(x, self.w, self.b)


class AdapterAttention(nn.Module):
    def __init__(self, d: int, device=None):
        super().__init__()
        self.wqkv = _param(3 * d, d, device=device)
        self.bqkv = _param(3 * d, device=device)
        self.wo = _param(d, d, device=device)
        self.bo = _param(d, device=device)


class AdapterMLP(nn.Module):
    def __init__(self, d: int, f: int, device=None):
        super().__init__()
        self.w1 = _param(f, d, device=device)
        self.b1 = _param(f, device=device)
        self.w2 = _param(d, f, device=device)
        self.b2 = _param(d, device=device)


class AdapterBlock(nn.Module):
    def __init__(self, d: int, f: int, device=None):
        super().__init__()
        self.ln_1 = nn.LayerNorm(d, device=device)
        self.ln_2 = nn.LayerNorm(d, device=device)
        self.attn = AdapterAttention(d, device=device)
        self.mlp = AdapterMLP(d, f, device=device)


class AdapterBlocks(nn.Module):
    def __init__(self, d: int, f: int, layers: int, device=None):
        super().__init__()
        self.layers = nn.ModuleList(AdapterBlock(d, f, device=device)
                                    for _ in range(layers))


class Adapter(nn.Module):
    """The transformer adapter's parameters (JAX `params['adapter']`)."""

    def __init__(self, cfg: AdapterConfig, device=None):
        super().__init__()
        assert cfg.adapter_type == "trans", cfg.adapter_type
        self.in_proj = Projection(cfg.d_model, cfg.in_dim, device=device)
        self.out_proj = Projection(cfg.in_dim, cfg.d_model, device=device)
        self.blocks = AdapterBlocks(cfg.d_model, cfg.ffn_dim, cfg.num_layers,
                                    device=device)


@torch.no_grad()
def init_adapter_params(cfg: AdapterConfig, generator: torch.Generator,
                        device=None) -> Optional[Adapter]:
    """Random adapter (torch's own initializers, as the JAX package's
    `init_adapter_params`): xavier-uniform in-projection of the attention,
    torch-Linear-uniform projections and MLP, zero attention biases, norms
    identity. None for the identity adapter."""
    if cfg.adapter_type == "identity":
        return None
    device = generator.device if device is None else torch.device(device)
    adapter = Adapter(cfg, device=device)
    d = cfg.d_model

    def uniform(p, bound):
        p.copy_((torch.rand(p.shape, generator=generator,
                            device=generator.device) * 2 - 1) * bound)

    def linear(w, b):
        bound = (1.0 / w.shape[1]) ** 0.5
        uniform(w, bound)
        uniform(b, bound)

    for blk in adapter.blocks.layers:
        uniform(blk.attn.wqkv, (6.0 / (3 * d + d)) ** 0.5)
        uniform(blk.attn.wo, (1.0 / d) ** 0.5)
        linear(blk.mlp.w1, blk.mlp.b1)
        linear(blk.mlp.w2, blk.mlp.b2)
    linear(adapter.in_proj.w, adapter.in_proj.b)
    linear(adapter.out_proj.w, adapter.out_proj.b)
    return adapter


def _dropped(x: torch.Tensor, p: float,
             generator: Optional[torch.Generator]) -> torch.Tensor:
    """x * Bernoulli(1 - p) / (1 - p), drawn from `generator`; x itself
    without a generator or at p = 0."""
    if generator is None or p <= 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator,
                      device=generator.device) >= p
    return x * keep.to(x.device) / (1.0 - p)


def _mha(attn: AdapterAttention, x: torch.Tensor, heads: int,
         pad: torch.Tensor, p: float,
         generator: Optional[torch.Generator]) -> torch.Tensor:
    """torch.nn.MultiheadAttention with key_padding_mask semantics; a query
    whose keys are all padded gets zero attention (softmax's NaN zeroed)."""
    B, T, D = x.shape
    dh = D // heads
    q, k, v = dense(x, attn.wqkv, attn.bqkv).split(D, dim=-1)
    q, k, v = (t.reshape(B, T, heads, dh).transpose(1, 2) for t in (q, k, v))
    scores = torch.einsum("bhqd,bhkd->bhqk", (q * dh ** -0.5).float(),
                          k.float())
    scores = scores.masked_fill(pad[:, None, None, :], float("-inf"))
    probs = torch.nan_to_num(torch.softmax(scores, dim=-1)).to(x.dtype)
    probs = _dropped(probs, p, generator)
    o = torch.einsum("bhqk,bhkd->bhqd", probs.float(), v.float()).to(x.dtype)
    return dense(o.transpose(1, 2).reshape(B, T, D), attn.wo, attn.bo)


def apply_adapter(adapter: Optional[Adapter], cfg: AdapterConfig,
                  feats: torch.Tensor, valid: torch.Tensor, *,
                  train: bool = False,
                  generator: Optional[torch.Generator] = None
                  ) -> torch.Tensor:
    """[B, T, C] view features + [B, T] valid mask -> adapted [B, T, C].
    Dropout (cfg.dropout) only when `train` and `generator` are given."""
    if cfg.adapter_type == "identity":
        return feats
    pad = ~valid.bool()
    gen = generator if train else None
    p = cfg.dropout
    h = adapter.in_proj(feats)
    for blk in adapter.blocks.layers:
        a = _mha(blk.attn, layer_norm(h, blk.ln_1), cfg.num_heads, pad, p, gen)
        h = h + _dropped(a, p, gen)
        y = torch.relu(dense(layer_norm(h, blk.ln_2), blk.mlp.w1, blk.mlp.b1))
        h = h + _dropped(dense(_dropped(y, p, gen), blk.mlp.w2, blk.mlp.b2),
                         p, gen)
    x = adapter.out_proj(h)
    res = cfg.residual
    return feats * res + x * (1.0 - res)
