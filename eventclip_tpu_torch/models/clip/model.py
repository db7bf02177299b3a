"""CLIP encoders as PyTorch modules.

Port of eventclip_tpu/models/clip/model.py (the OpenAI CLIP ViT image tower
and causal text tower; `CLIP` builds models/clip/resnet.py's tower for a
ResNet config). Parameters keep the JAX package's names and layouts —
weights in torch [out, in] order, the fused in-projection as one [3D, D]
matrix — but each tower holds a `ModuleList` of blocks instead of
`[L, ...]`-stacked arrays (models/clip/convert.py bridges the two).

Numerics follow the JAX package: parameters are stored in float32 and
matmul weights are cast to the activation dtype at use; matmuls accumulate
in float32; layer norms always compute in float32; attention runs through
the fused-qkv kernels (ops/attention.py), whose gradient is the backward
kernel. Gradients follow JAX's rules too: a weight's gradient through a bf16
matmul is rounded to bf16 before it reaches the f32 master weight.

`remat=True` recomputes each block in the backward pass
(`torch.utils.checkpoint`, as the JAX package's `jax.checkpoint` per scan
body). LoRA deltas are [L, ...]-stacked like the JAX package's
(`init_lora_params`), applied in the attention as (x A^T) B^T.

Inference options, as the JAX package's: `keep_tokens` prunes the patch
sequence to its highest-variance patches before the tower; a tower whose
weights were quantized by ops/quant.py runs its products through `qdense`
(`dense` dispatches on the `QWeight`); a calibration copy holding
`AmaxRecorder`s in their place notes the max-abs of those products'
inputs.

Tensor parallelism (`tp=`, a parallel/sharding.py `TPContext`, on
weights cut by its `shard_params`): Megatron's pair of operators, as the
JAX package's GSPMD program computes them. The column-parallel products
(`wqkv`, `w1`) take the replicated input and give this rank's output
features (local f32 bias, one rounding); their backward sums the f32
input-gradient partials over the model group before rounding. The
row-parallel products (`wo`, `w2`) sum their f32 partial products over
the model group, then add the replicated f32 bias and round once (the
JAX `dense` reduces the f32 einsum before `+ b`). Attention runs the
fused kernels on the rank's heads (`tp_fused_qkv_attention`). LoRA
factors stay replicated and each rank uses its rows of q/k/v's B and its
columns of o's A; o's delta joins the row-parallel partial sum. int8
weights and token pruning are single-card inference paths.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ...ops.attention import fused_qkv_attention, tp_fused_qkv_attention
from ...ops.dense import dense_bf16
from ...ops.quant import AmaxRecorder, QWeight, qdense
from ...parallel.distributed import model_all_reduce_sum_
from .config import (CLIPConfig, EVAVisionConfig, ResNetVisionConfig,
                     TextConfig, VisionConfig)
from .resnet import ResNetVisionTower, init_resnet_visual_


# ---------------------------------------------------------------------------
# primitive layers
# ---------------------------------------------------------------------------


def _dense_f32_acc(x2, w, b):
    """bf16 [N, in] @ w.T with the f32 bias added to the f32 accumulator,
    rounded once to x2's dtype (CUDA only): `eventclip::dense_bf16`
    (ops/dense.py), also while a graph is traced (export.py), where it
    stays one node a product."""
    return dense_bf16(x2, w, None if b is None else b.float())


class _DenseF32Acc(torch.autograd.Function):
    """bf16 x [N, in] @ w.T [in, out] (+ f32 b) on the card: the f32
    accumulator, the bias added there, one rounding (`_dense_f32_acc`).
    The backward is JAX's: the bf16 output gradient, read as
    f32, against the bf16 operands, summed in f32 and rounded to bf16 for x
    and w; the bias gradient its f32 column sum."""

    @staticmethod
    def forward(ctx, x2, w, b):
        ctx.save_for_backward(x2, w)
        return _dense_f32_acc(x2, w, b)

    @staticmethod
    def backward(ctx, g):
        x2, w = ctx.saved_tensors
        gx = gw = gb = None
        if ctx.needs_input_grad[0]:
            gx = torch.mm(g, w, out_dtype=torch.float32).to(x2.dtype)
        if ctx.needs_input_grad[1]:
            gw = torch.mm(g.t(), x2, out_dtype=torch.float32).to(w.dtype)
        if ctx.needs_input_grad[2]:
            gb = g.float().sum(0)
        return gx, gw, gb


def dense(x: torch.Tensor, w, b: Optional[torch.Tensor] = None
          ) -> torch.Tensor:
    """x @ w.T + b; w is [out, in]. The product of x and w rounded to x's
    dtype, accumulated in f32, plus the f32 bias, rounded once to x's
    dtype: the JAX package's `dense`. An int8 `QWeight` (ops/quant.py)
    takes the W8A8 product, `qdense`; an `AmaxRecorder` notes max |x| and
    takes the float product.

    On CUDA a bf16 product is `eventclip::dense_bf16` (ops/dense.py): the
    hand-written GEMM D1 (csrc/dense.cu) adds the f32 bias to its f32
    accumulator in registers and rounds once, for every product whose K
    and N rows are 16-byte multiples (K and N multiples of 8, which TMA
    needs: `d1_takes`); any other (ViT-L/14's patch embedding, K = 588)
    keeps the library GEMM that writes its f32 accumulator, the bias added
    there, rounded after it. The CPU has no such matmul; there the f32
    product of the rounded operands is the same sum, since a product of
    two bf16 values is exact in f32, and autograd through the casts gives
    JAX's gradient rules."""
    if isinstance(w, QWeight):
        return qdense(x, w, b)
    if isinstance(w, AmaxRecorder):
        w = w.see(x)
    w = w.to(x.dtype)
    if x.dtype == torch.float32:
        return F.linear(x, w, b)
    x2 = x.reshape(-1, x.shape[-1])
    if x.is_cuda:
        # without a gradient to record (serving, and torch.export under
        # no_grad) the forward is the op alone, one node in a trace
        y = (_DenseF32Acc.apply(x2, w, b) if torch.is_grad_enabled()
             else _dense_f32_acc(x2, w, b))
    else:
        y = torch.mm(x2.float(), w.float().t())
        if b is not None:
            y = y + b.float()
        y = y.to(x.dtype)
    return y.reshape(*x.shape[:-1], w.shape[0])


# -- tensor parallelism: Megatron's column- and row-parallel products -------


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b accumulated and returned in f32 (operands in a's dtype): the
    card's GEMM writes its f32 accumulator; the CPU takes the f32 product
    of the rounded operands, the same sum."""
    if a.dtype == torch.float32:
        return torch.mm(a, b.float())
    if a.is_cuda:
        return torch.mm(a, b.to(a.dtype), out_dtype=torch.float32)
    return torch.mm(a.float(), b.to(a.dtype).float())


class _ColumnParallel(torch.autograd.Function):
    """x [N, in] (replicated) @ w_r.T (+ f32 b_r): this rank's output
    features, the f32 accumulator plus the bias rounded once (`dense`).
    Backward: the f32 partial input gradient summed over the model group,
    then rounded; the weight gradient in x's dtype, the bias gradient the
    f32 column sum."""

    @staticmethod
    def forward(ctx, x2, w, b, tp):
        ctx.save_for_backward(x2, w)
        ctx.tp = tp
        y = _mm_f32(x2, w.t())
        if b is not None:
            y = y + b.float()
        return y.to(x2.dtype)

    @staticmethod
    def backward(ctx, g):
        x2, w = ctx.saved_tensors
        gx = gw = gb = None
        if ctx.needs_input_grad[0]:
            gx = model_all_reduce_sum_(_mm_f32(g, w), ctx.tp).to(x2.dtype)
        if ctx.needs_input_grad[1]:
            gw = _mm_f32(g.t(), x2).to(w.dtype)
        if ctx.needs_input_grad[2]:
            gb = g.float().sum(0)
        return gx, gw, gb, None


class _RowParallel(torch.autograd.Function):
    """x_r [N, in/n] @ w_r.T [in/n, out]: the f32 partial product (plus an
    f32 `extra` partial, o's LoRA delta), summed over the model group in
    f32, then the replicated f32 bias added and the sum rounded once.
    Backward: the output gradient is replicated, so the local input,
    weight and bias gradients need no sum."""

    @staticmethod
    def forward(ctx, x2, w, b, tp, extra):
        ctx.save_for_backward(x2, w)
        y = _mm_f32(x2, w.t())
        if extra is not None:
            y = y + extra
        model_all_reduce_sum_(y, tp)
        if b is not None:
            y = y + b.float()
        return y.to(x2.dtype)

    @staticmethod
    def backward(ctx, g):
        x2, w = ctx.saved_tensors
        gx = gw = gb = ge = None
        if ctx.needs_input_grad[0]:
            gx = _mm_f32(g, w).to(x2.dtype)
        if ctx.needs_input_grad[1]:
            gw = _mm_f32(g.t(), x2).to(w.dtype)
        if ctx.needs_input_grad[2]:
            gb = g.float().sum(0)
        if ctx.needs_input_grad[4]:
            ge = g.float()
        return gx, gw, gb, None, ge


class _CopyToModel(torch.autograd.Function):
    """Identity forward on a replicated input; backward sums the
    gradient's f32 partials over the model group (the q/k/v LoRA deltas,
    whose B each rank uses in part)."""

    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return model_all_reduce_sum_(g.float(), ctx.tp).to(g.dtype), None


def column_parallel(x: torch.Tensor, w: torch.Tensor,
                    b: Optional[torch.Tensor], tp) -> torch.Tensor:
    """[..., in] replicated -> [..., out/n] this rank's features (`tp`
    the layout whose model group sums the input gradient)."""
    x2 = x.reshape(-1, x.shape[-1])
    y = _ColumnParallel.apply(x2, w.to(x.dtype), b, tp)
    return y.reshape(*x.shape[:-1], w.shape[0])


def row_parallel(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
                 tp, extra: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[..., in/n] this rank's features -> [..., out] replicated (summed
    over `tp`'s model group)."""
    x2 = x.reshape(-1, x.shape[-1])
    y = _RowParallel.apply(x2, w.to(x.dtype), b, tp, extra)
    return y.reshape(*x.shape[:-1], w.shape[0])


def layer_norm(x: torch.Tensor, ln: nn.LayerNorm) -> torch.Tensor:
    """LayerNorm computed in float32 (f32 statistics, f32 weight and bias)
    regardless of activation dtype, rounded once to x's dtype. The up-cast
    is explicit: CUDA's layer norm refuses a bf16 input with f32 weights."""
    y = F.layer_norm(x.float(), ln.normalized_shape, ln.weight.float(),
                     ln.bias.float(), ln.eps)
    return y.to(x.dtype)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


def activation(name: str):
    """A text tower's MLP activation by its config's `act`: OpenAI's
    "quick_gelu" or exact "gelu" (looked up when called)."""
    return F.gelu if name == "gelu" else quick_gelu


def lora_delta(x: torch.Tensor, a: torch.Tensor,
               b: torch.Tensor) -> torch.Tensor:
    """Low-rank delta (x A^T) B^T; A [r, in], B [out, r], each product
    rounded to x's dtype (the JAX package's `_lora_delta`)."""
    return dense(dense(x, a), b)


def causal_mask(T: int, device=None) -> torch.Tensor:
    """Additive [T, T] f32 mask, -inf above the diagonal."""
    return torch.full((T, T), float("-inf"), device=device).triu(1)


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------


def _param(*shape, zeros: bool = False, device=None) -> nn.Parameter:
    return nn.Parameter((torch.zeros if zeros else torch.empty)(
        *shape, device=device))


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


class CLIP(nn.Module):
    def __init__(self, cfg: CLIPConfig, device=None):
        super().__init__()
        self.cfg = cfg
        from .eva import EVAVisionTower

        tower = (ResNetVisionTower if isinstance(cfg.vision,
                                                 ResNetVisionConfig)
                 else EVAVisionTower if isinstance(cfg.vision,
                                                   EVAVisionConfig)
                 else VisionTower)
        self.visual = tower(cfg.vision, device=device)
        self.text = TextTower(cfg.text, device=device)
        self.logit_scale = _param((), device=device)


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


def encode_image(visual: VisionTower, images: torch.Tensor, *,
                 dtype: torch.dtype = torch.float32,
                 lora: Optional[LoRA] = None,
                 remat: bool = False,
                 keep_tokens: Optional[int] = None,
                 tp=None) -> torch.Tensor:
    """[B, 3, H, W] CLIP-normalized images -> [B, output_dim] f32 features.

    keep_tokens=K (eval-time, opt-in) keeps the K highest-variance patches
    (`prune_patches`), each with its own positional embedding, in raster
    order; K = grid² reproduces the full forward. `tp` runs the blocks
    tensor-parallel (on weights cut by parallel/sharding.py). An EVA02
    tower (models/clip/eva.py) takes its own forward, which refuses LoRA,
    remat, pruning, `tp` and a recorded gradient."""
    cfg = visual.cfg
    if isinstance(cfg, EVAVisionConfig):
        from .eva import encode_image_eva

        return encode_image_eva(visual, images, dtype=dtype, lora=lora,
                                remat=remat, keep_tokens=keep_tokens, tp=tp)
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
# initialization
# ---------------------------------------------------------------------------


def _normal_(p: torch.Tensor, std: float, gen: torch.Generator) -> None:
    p.copy_(torch.randn(p.shape, generator=gen, device=gen.device) * std)


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


@torch.no_grad()
def init_clip_params(cfg: CLIPConfig, generator: torch.Generator,
                     device=None) -> CLIP:
    """Random CLIP towers (OpenAI init scheme, as the JAX package's
    `init_clip_params`; a ResNet image tower as its `init_resnet_visual`)
    drawn from `generator`, built on `device` (default: the generator's
    device). Biases zero, norms identity."""
    device = generator.device if device is None else torch.device(device)
    model = CLIP(cfg, device=device)
    v, t = model.visual, model.text
    if isinstance(v, ResNetVisionTower):
        init_resnet_visual_(v, generator)
    elif isinstance(cfg.vision, EVAVisionConfig):
        from .eva import init_eva_visual_

        init_eva_visual_(v, generator)
    else:
        scale = cfg.vision.width ** -0.5
        for p in (v.patch_embed, v.class_embedding, v.positional_embedding,
                  v.proj):
            _normal_(p, scale, generator)
        _init_blocks(v.blocks, cfg.vision.width, generator)
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
    if not isinstance(cfg, VisionConfig):
        # the JAX package fails here too (a TypeError on the stage tuple)
        raise TypeError("LoRA targets the ViT attention (lora.py:385); a "
                        "ResNet tower has none")
    device = generator.device if device is None else torch.device(device)
    r = parsed["rank"]
    lora = LoRA({t: LoRAFactors(cfg.layers, r, cfg.width, device=device)
                 for t in parsed["targets"]})
    for f in lora.values():
        _normal_(f.a, 1.0 / r, generator)
    return lora
