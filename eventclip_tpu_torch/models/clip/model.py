"""CLIP encoders as PyTorch modules, and `TOWERS`, the table of towers.

Port of eventclip_tpu/models/clip/model.py (the OpenAI CLIP ViT image tower
and causal text tower). Parameters keep the JAX package's names and
layouts — weights in torch [out, in] order, the fused in-projection as one
[3D, D] matrix — but each tower holds a `ModuleList` of blocks instead of
`[L, ...]`-stacked arrays (models/clip/convert.py bridges the two).
Products, norms and the tensor-parallel operators are models/clip/layers.py's;
attention runs through the fused-qkv kernels (ops/attention.py), whose
gradient is the backward kernel.

`TOWERS` maps a vision config's type to its tower: the module `CLIP`
builds, the forward `encode_image` takes, `init_clip_params`'s init and
the up-front options that the tower's own module declares it refuses,
which callers ask through `refuse_option`. Imports point one way:
layers.py, then resnet.py and eva.py, then this module.

The ViT's options are the JAX package's: `remat`, LoRA deltas
[L, ...]-stacked (`init_lora_params`), `keep_tokens` and `tp`; int8
weights and token pruning are single-card inference paths.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ...ops.attention import fused_qkv_attention, tp_fused_qkv_attention
from ...ops.quant import AmaxRecorder, QWeight
from . import eva, resnet
from .config import (CLIPConfig, EVAVisionConfig, ResNetVisionConfig,
                     TextConfig, VisionConfig)
from .layers import (_CopyToModel, _normal_, _param, causal_mask,
                     column_parallel, dense, layer_norm, lora_delta,
                     row_parallel)


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------


# one layer's LoRA factors: target ('q'|'k'|'v'|'o') -> (A [r, D], B [D, r])
LayerLoRA = Dict[str, Tuple[torch.Tensor, torch.Tensor]]


class LoRAFactors(nn.Module):
    """One target's [L, r, D] A and [L, D, r] B (JAX `lora/<t>/a|b`)."""

    def __init__(self, layers: int, rank: int, width: int, device=None):
        super().__init__()
        self.a = _param(layers, rank, width, device=device)
        self.b = _param(layers, width, rank, zeros=True, device=device)


class LoRA(nn.ModuleDict):
    """Stacked LoRA deltas of the visual tower, by target."""

    def layer(self, i: int) -> LayerLoRA:
        return {t: (f.a[i], f.b[i]) for t, f in self.items()}


class Attention(nn.Module):
    """Multi-head self attention matching torch.nn.MultiheadAttention, with
    the fused qkv projection feeding the fused-qkv attention kernel."""

    def __init__(self, width: int, heads: int, device=None):
        super().__init__()
        self.heads = heads
        self.wqkv = _param(3 * width, width, device=device)
        self.bqkv = _param(3 * width, zeros=True, device=device)
        self.wo = _param(width, width, device=device)
        self.bo = _param(width, zeros=True, device=device)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                lora: Optional[LayerLoRA] = None, tp=None) -> torch.Tensor:
        if tp is not None:
            return self._tp_forward(x, mask, lora, tp)
        qkv = dense(x, self.wqkv, self.bqkv)  # [B, T, 3D]
        if lora is not None:
            zeros = torch.zeros_like(x)
            qkv = qkv + torch.cat([
                lora_delta(x, *lora[t]) if t in lora else zeros
                for t in ("q", "k", "v")], dim=-1)
        o = fused_qkv_attention(qkv, self.heads, mask)
        out = dense(o, self.wo, self.bo)
        if lora is not None and "o" in lora:
            out = out + lora_delta(o, *lora["o"])
        return out

    def _tp_forward(self, x, mask, lora, tp):
        """One model rank: its heads of q, k and v (column-parallel), the
        fused kernel on them, the row-parallel out-projection."""
        if isinstance(self.wqkv, (QWeight, AmaxRecorder)):
            raise AssertionError("int8 quantization is a single-chip "
                                 "inference path (no TP)")
        qkv = column_parallel(x, self.wqkv, self.bqkv, tp)  # [B, T, 3D/n]
        Dl = qkv.shape[-1] // 3
        lo, hi = tp.model_index * Dl, (tp.model_index + 1) * Dl
        if lora is not None:
            xr = _CopyToModel.apply(x, tp)
            zeros = x.new_zeros(x.shape[:-1] + (Dl,))
            qkv = qkv + torch.cat([
                dense(dense(xr, lora[t][0]), lora[t][1][lo:hi])
                if t in lora else zeros for t in ("q", "k", "v")], dim=-1)
        o = tp_fused_qkv_attention(qkv, self.heads, tp, mask)
        extra = None
        if lora is not None and "o" in lora:
            a, b = lora["o"]
            o2 = o.reshape(-1, Dl).float()
            # this rank's f32 partial of (o A^T) B^T over its columns of A
            extra = (o2 @ a[:, lo:hi].to(o.dtype).float().t()) \
                @ b.to(o.dtype).float().t()
        return row_parallel(o, self.wo, self.bo, tp, extra)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


def activation(name: str):
    """A text tower's MLP activation by its config's `act`: OpenAI's
    "quick_gelu" or exact "gelu" (looked up when called)."""
    return F.gelu if name == "gelu" else quick_gelu


class MLP(nn.Module):
    def __init__(self, width: int, device=None, act: str = "quick_gelu"):
        super().__init__()
        self.act = act
        self.w1 = _param(4 * width, width, device=device)
        self.b1 = _param(4 * width, zeros=True, device=device)
        self.w2 = _param(width, 4 * width, device=device)
        self.b2 = _param(width, zeros=True, device=device)

    def forward(self, x: torch.Tensor, tp=None) -> torch.Tensor:
        if tp is not None:
            h = activation(self.act)(column_parallel(x, self.w1, self.b1,
                                                     tp))
            return row_parallel(h, self.w2, self.b2, tp)
        return dense(activation(self.act)(dense(x, self.w1, self.b1)),
                     self.w2, self.b2)


class Block(nn.Module):
    """Pre-norm residual transformer block."""

    def __init__(self, width: int, heads: int, device=None,
                 act: str = "quick_gelu"):
        super().__init__()
        self.ln_1 = nn.LayerNorm(width, device=device)
        self.attn = Attention(width, heads, device=device)
        self.ln_2 = nn.LayerNorm(width, device=device)
        self.mlp = MLP(width, device=device, act=act)

    def forward(self, h: torch.Tensor, mask: Optional[torch.Tensor] = None,
                lora: Optional[LayerLoRA] = None, tp=None) -> torch.Tensor:
        h = h + self.attn(layer_norm(h, self.ln_1), mask, lora, tp)
        return h + self.mlp(layer_norm(h, self.ln_2), tp)


class Transformer(nn.Module):
    def __init__(self, width: int, layers: int, heads: int, device=None,
                 act: str = "quick_gelu"):
        super().__init__()
        self.layers = nn.ModuleList(
            Block(width, heads, device=device, act=act)
            for _ in range(layers))

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                lora: Optional["LoRA"] = None,
                remat: bool = False, tp=None) -> torch.Tensor:
        """remat=True keeps only each block's input for the backward pass
        and recomputes the block there (activation memory O(1) in depth,
        about a third more FLOPs), when a gradient is being recorded.
        Under `tp` the recomputation repeats the block's model-group
        sums, in the same order on every rank."""
        remat = remat and torch.is_grad_enabled()
        for i, block in enumerate(self.layers):
            li = None if lora is None else lora.layer(i)
            if remat:
                x = checkpoint(block, x, mask, li, tp, use_reentrant=False)
            else:
                x = block(x, mask, li, tp)
        return x


# ---------------------------------------------------------------------------
# towers
# ---------------------------------------------------------------------------


class VisionTower(nn.Module):
    def __init__(self, cfg: VisionConfig, device=None):
        super().__init__()
        self.cfg = cfg
        D = cfg.width
        self.patch_embed = _param(D, 3 * cfg.patch_size ** 2, device=device)
        self.class_embedding = _param(D, device=device)
        self.positional_embedding = _param(cfg.seq_len, D, device=device)
        self.ln_pre = nn.LayerNorm(D, device=device)
        self.ln_post = nn.LayerNorm(D, device=device)
        self.proj = _param(D, cfg.output_dim, device=device)
        self.blocks = Transformer(D, cfg.layers, cfg.heads, device=device)


class TextTower(nn.Module):
    def __init__(self, cfg: TextConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.token_embedding = _param(cfg.vocab_size, cfg.width,
                                      device=device)
        self.positional_embedding = _param(cfg.context_length, cfg.width,
                                           device=device)
        self.ln_final = nn.LayerNorm(cfg.width, device=device)
        self.projection = _param(cfg.width, cfg.output_dim, device=device)
        self.blocks = Transformer(cfg.width, cfg.layers, cfg.heads,
                                  device=device, act=cfg.act)


def prune_patches(x: torch.Tensor, keep_tokens: int) -> torch.Tensor:
    """[B, P, F] dtype-rounded patches -> [B, K] indices of the K
    highest-variance patches, in raster order. The score is the population
    variance in f32 (JAX `var`, ddof 0). Event frames are mostly uniform
    background, so ties at the cut are the normal case; among equal scores
    the lowest index wins, as in `jax.lax.top_k` (a stable descending
    sort, where `torch.topk` leaves the order of ties unspecified)."""
    score = x.float().var(dim=-1, correction=0)
    order = torch.sort(score, dim=-1, descending=True, stable=True).indices
    return torch.sort(order[:, :keep_tokens], dim=-1).values


def encode_image_vit(visual: VisionTower, images: torch.Tensor, *,
                     dtype: torch.dtype = torch.float32,
                     lora: Optional[LoRA] = None,
                     remat: bool = False,
                     keep_tokens: Optional[int] = None,
                     tp=None) -> torch.Tensor:
    """[B, 3, H, W] CLIP-normalized images -> [B, output_dim] f32 features.

    keep_tokens=K (eval-time, opt-in) keeps the K highest-variance patches
    (`prune_patches`), each with its own positional embedding, in raster
    order; K = grid² reproduces the full forward. `tp` runs the blocks
    tensor-parallel (on weights cut by parallel/sharding.py)."""
    cfg = visual.cfg
    B = images.shape[0]
    ps, g, D = cfg.patch_size, cfg.grid, cfg.width
    x = images.to(dtype)
    # patchify: the stride-ps conv1 as one matmul
    x = x.reshape(B, 3, g, ps, g, ps).permute(0, 2, 4, 1, 3, 5)
    x = x.reshape(B, g * g, 3 * ps * ps)
    pos = visual.positional_embedding.to(dtype)
    if keep_tokens is not None and keep_tokens < g * g:
        if tp is not None:
            raise AssertionError("token pruning is a single-chip inference "
                                 "path")
        idx = prune_patches(x, keep_tokens)
        x = torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))
        pos_tok = pos[1:][idx]  # [B, K, D]: embeddings follow their patches
    else:
        pos_tok = pos[1:][None]
    x = dense(x, visual.patch_embed) + pos_tok
    cls = (visual.class_embedding.to(dtype) + pos[0]).expand(B, 1, D)
    x = torch.cat([cls, x], dim=1)
    x = layer_norm(x, visual.ln_pre)
    x = visual.blocks(x, lora=lora, remat=remat, tp=tp)
    x = layer_norm(x[:, 0], visual.ln_post)
    # the f32 product of dtype-rounded operands = f32 accumulation
    return torch.matmul(x.float(), visual.proj.to(dtype).float())


def encode_text(text: TextTower, tokens: torch.Tensor, *,
                dtype: torch.dtype = torch.float32, tp=None) -> torch.Tensor:
    """[B, context] int token ids -> [B, output_dim] f32 features, pooled at
    the EOT token (the highest id, so `argmax` finds it). `tp` runs the
    blocks tensor-parallel, the causal mask on each rank's heads."""
    T = tokens.shape[-1]
    x = text.token_embedding[tokens].to(dtype)
    x = x + text.positional_embedding[:T].to(dtype)
    x = text.blocks(x, causal_mask(T, device=x.device), tp=tp)
    x = layer_norm(x, text.ln_final)
    eot = tokens.argmax(-1)
    x = x[torch.arange(x.shape[0], device=x.device), eot]
    return torch.matmul(x.float(), text.projection.to(dtype).float())


# ---------------------------------------------------------------------------
# initialization, and the table of vision towers
# ---------------------------------------------------------------------------


def _init_blocks(blocks: Transformer, width: int, gen: torch.Generator):
    layers = len(blocks.layers)
    proj_std = (width ** -0.5) * ((2 * layers) ** -0.5)
    attn_std = width ** -0.5
    fc_std = (2 * width) ** -0.5
    for blk in blocks.layers:
        _normal_(blk.attn.wqkv, attn_std, gen)
        _normal_(blk.attn.wo, proj_std, gen)
        _normal_(blk.mlp.w1, fc_std, gen)
        _normal_(blk.mlp.w2, proj_std, gen)


def init_vit_visual_(v: VisionTower, generator: torch.Generator) -> None:
    """Random ViT weights in place (OpenAI's scheme)."""
    scale = v.cfg.width ** -0.5
    for p in (v.patch_embed, v.class_embedding, v.positional_embedding,
              v.proj):
        _normal_(p, scale, generator)
    _init_blocks(v.blocks, v.cfg.width, generator)


class Tower(NamedTuple):
    """A vision tower: the module `CLIP` builds, its forward, its random
    init in place, and the up-front options it refuses (option -> a
    function of the option and the vision config giving the exception)."""

    module: Callable[..., nn.Module]
    encode: Callable[..., torch.Tensor]
    init: Callable[[nn.Module, torch.Generator], None]
    refuses: Mapping[str, Callable[[str, object], Exception]]


TOWERS: Dict[type, Tower] = {
    VisionConfig: Tower(VisionTower, encode_image_vit, init_vit_visual_, {}),
    ResNetVisionConfig: Tower(resnet.ResNetVisionTower,
                              resnet.encode_image_resnet,
                              resnet.init_resnet_visual_, resnet.REFUSES),
    EVAVisionConfig: Tower(eva.EVAVisionTower, eva.encode_image_eva,
                           eva.init_eva_visual_, eva.REFUSES),
}


def refuse_option(vision, option: str) -> None:
    """Raise what the `REFUSES` of `vision`'s tower module declares for
    `option`; return if the tower takes it."""
    make = TOWERS[type(vision)].refuses.get(option)
    if make is not None:
        raise make(option, vision)


class CLIP(nn.Module):
    def __init__(self, cfg: CLIPConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.visual = TOWERS[type(cfg.vision)].module(cfg.vision,
                                                     device=device)
        self.text = TextTower(cfg.text, device=device)
        self.logit_scale = _param((), device=device)


def encode_image(visual: nn.Module, images: torch.Tensor,
                 **options) -> torch.Tensor:
    """[B, 3, H, W] CLIP-normalized images -> [B, output_dim] f32 features
    through the tower's own forward (`TOWERS`), with `encode_image_vit`'s
    keyword options: the ViT takes them all; a ResNet asserts LoRA absent
    and ignores the rest; an EVA02 tower refuses LoRA, remat, pruning,
    `tp` and a recorded gradient."""
    return TOWERS[type(visual.cfg)].encode(visual, images, **options)


@torch.no_grad()
def init_clip_params(cfg: CLIPConfig, generator: torch.Generator,
                     device=None) -> CLIP:
    """Random CLIP towers (OpenAI init scheme, as the JAX package's
    `init_clip_params`; the image tower by its own init in `TOWERS`)
    drawn from `generator`, built on `device` (default: the generator's
    device). Biases zero, norms identity."""
    device = generator.device if device is None else torch.device(device)
    model = CLIP(cfg, device=device)
    t = model.text
    TOWERS[type(cfg.vision)].init(model.visual, generator)
    _normal_(t.token_embedding, 0.02, generator)
    _normal_(t.positional_embedding, 0.01, generator)
    _normal_(t.projection, cfg.text.width ** -0.5, generator)
    _init_blocks(t.blocks, cfg.text.width, generator)
    model.logit_scale.fill_(float(torch.log(torch.tensor(1.0 / 0.07))))
    return model.to(device)


# ---------------------------------------------------------------------------
# LoRA parameter trees
# ---------------------------------------------------------------------------


def parse_lora_spec(spec) -> Optional[dict]:
    """Parse the reference's LoRA rank spec (models/lora.py:356-368).

    int r > 0      -> rank r on q, k, v
    'qv-16'        -> rank 16 on q, v
    'qkv-16'       -> q, k, v;  'qkvo-16' -> q, k, v and out-proj
    anything else  -> None (LoRA disabled)
    """
    if isinstance(spec, bool) or spec is None:
        return None
    if isinstance(spec, int):
        return {"rank": spec, "targets": ("q", "k", "v")} if spec > 0 else None
    assert isinstance(spec, str) and "q" in spec and "v" in spec
    rank = int(spec.split("-")[-1])
    targets = ["q", "v"]
    if "k" in spec.split("-")[0]:
        targets.insert(1, "k")
    if "o" in spec:
        targets.append("o")
    return {"rank": rank, "targets": tuple(targets)}


@torch.no_grad()
def init_lora_params(cfg: VisionConfig, spec, generator: torch.Generator,
                     device=None) -> Optional[LoRA]:
    """Stacked [L, ...] LoRA deltas for the visual tower drawn from
    `generator`: B zero, A ~ N(0, 1/r) (scaled by 1/r, as the JAX package
    does); None when `spec` disables LoRA."""
    parsed = parse_lora_spec(spec)
    if parsed is None:
        return None
    refuse_option(cfg, "LoRA")
    device = generator.device if device is None else torch.device(device)
    r = parsed["rank"]
    lora = LoRA({t: LoRAFactors(cfg.layers, r, cfg.width, device=device)
                 for t in parsed["targets"]})
    for f in lora.values():
        _normal_(f.a, 1.0 / r, generator)
    return lora
