"""CLIP ModifiedResNet image towers (RN50 ... RN50x64) as PyTorch modules.

Port of eventclip_tpu/models/clip/resnet.py. OpenAI's ModifiedResNet
differs from a torchvision ResNet in three ways (CLIP paper §2.4): a 3-conv
stem with an average pool; anti-aliased stride (every stride-2 convolution
is a stride-1 convolution followed by a 2x2 average pool, in the residual
and the shortcut path); and attention pooling, one multi-head query (the
mean token) over the spatial tokens with a learned positional embedding.

Parameters keep the JAX package's tree, so models/clip/convert.py's one
name map (`jax_path`) serves both tower families: batch norms are frozen
and folded into an affine (`Affine`: `weight` is the JAX leaf `scale`, as
for a layer norm), convolution weights are bare parameters in torch's
[O, I, kh, kw] layout named as the JAX leaves (`conv1`, `downsample.conv`),
never `weight`, and the blocks after a stage's first sit in `rest.layers`,
the JAX package's `rest` stacked along a leading axis.

Numerics follow the JAX package's rounding order in every dtype: a
convolution casts its weight to the activation dtype, accumulates in f32
and rounds once; the folded affine multiplies and adds in the activation
dtype (two roundings); the average pool is a reshape-mean; the attention
pool scales q by dh ** -0.5 in the activation dtype, takes both products
in f32 and rounds the softmax back to v's dtype. Convolutions are
`torch.nn.functional.conv2d` (cuDNN on the card, as the JAX tower's are
XLA's: no Pallas kernel stands behind them), with TF32 off for an f32
tower whatever the process's settings; the pool is plain torch, not the
attention kernels.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .config import ResNetVisionConfig
from .layers import _normal_, _param, dense

# the up-front options this tower refuses (`model.refuse_option` asks), with
# the JAX package's exceptions (its LoRA init fails on the stage tuple)
REFUSES = {
    "int8": lambda what, cfg: ValueError("int8 quantization supports the "
                                         "ViT towers only (ResNet archs "
                                         "run bf16)"),
    "LoRA": lambda what, cfg: TypeError("LoRA targets the ViT attention "
                                        "(lora.py:385); a ResNet tower has "
                                        "none")}


class Affine(nn.Module):
    """A frozen batch norm folded into scale (`weight`) and bias."""

    def __init__(self, c: int, device=None):
        super().__init__()
        self.weight = _param(c, device=device)
        self.bias = _param(c, zeros=True, device=device)


class Downsample(nn.Module):
    """The shortcut's 1x1 convolution and its folded batch norm."""

    def __init__(self, c_in: int, c_out: int, device=None):
        super().__init__()
        self.conv = _param(c_out, c_in, 1, 1, device=device)
        self.bn = Affine(c_out, device=device)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 -> (average pool when strided) -> 1x1, expansion 4."""

    def __init__(self, c_in: int, c_mid: int, downsample: bool,
                 device=None):
        super().__init__()
        self.conv1 = _param(c_mid, c_in, 1, 1, device=device)
        self.bn1 = Affine(c_mid, device=device)
        self.conv2 = _param(c_mid, c_mid, 3, 3, device=device)
        self.bn2 = Affine(c_mid, device=device)
        self.conv3 = _param(4 * c_mid, c_mid, 1, 1, device=device)
        self.bn3 = Affine(4 * c_mid, device=device)
        self.downsample = (Downsample(c_in, 4 * c_mid, device=device)
                           if downsample else None)


class Blocks(nn.Module):
    """A stage's blocks after the first (the JAX package's stacked
    `rest`)."""

    def __init__(self, blocks):
        super().__init__()
        self.layers = nn.ModuleList(blocks)


class Stage(nn.Module):
    def __init__(self, c_in: int, c_mid: int, n_blocks: int, device=None):
        super().__init__()
        self.block0 = Bottleneck(c_in, c_mid, True, device=device)
        self.rest = (Blocks(Bottleneck(4 * c_mid, c_mid, False,
                                       device=device)
                            for _ in range(n_blocks - 1))
                     if n_blocks > 1 else None)


class Stem(nn.Module):
    def __init__(self, width: int, device=None):
        super().__init__()
        w = width
        self.conv1 = _param(w // 2, 3, 3, 3, device=device)
        self.bn1 = Affine(w // 2, device=device)
        self.conv2 = _param(w // 2, w // 2, 3, 3, device=device)
        self.bn2 = Affine(w // 2, device=device)
        self.conv3 = _param(w, w // 2, 3, 3, device=device)
        self.bn3 = Affine(w, device=device)


class Linear(nn.Module):
    """`w` [out, in] and `b` [out] (the JAX leaves' names)."""

    def __init__(self, c_out: int, c_in: int, device=None):
        super().__init__()
        self.w = _param(c_out, c_in, device=device)
        self.b = _param(c_out, zeros=True, device=device)


class AttentionPool(nn.Module):
    def __init__(self, cfg: ResNetVisionConfig, device=None):
        super().__init__()
        C = cfg.embed_dim
        self.positional_embedding = _param(cfg.grid ** 2 + 1, C,
                                           device=device)
        self.q_proj = Linear(C, C, device=device)
        self.k_proj = Linear(C, C, device=device)
        self.v_proj = Linear(C, C, device=device)
        self.c_proj = Linear(cfg.output_dim, C, device=device)


class ResNetVisionTower(nn.Module):
    def __init__(self, cfg: ResNetVisionConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.stem = Stem(cfg.width, device=device)
        c_in = cfg.width
        for i, n in enumerate(cfg.layers):
            c_mid = cfg.stage_widths[i]
            setattr(self, f"layer{i + 1}",
                    Stage(c_in, c_mid, n, device=device))
            c_in = 4 * c_mid
        self.attnpool = AttentionPool(cfg, device=device)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def _conv(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
          padding: int = 0) -> torch.Tensor:
    """NCHW convolution: the weight cast to x's dtype, f32 accumulation,
    one rounding to x's dtype. cuDNN's reduced-precision convolutions
    accumulate in f32; the CPU takes the f32 convolution of the rounded
    operands, the same sum."""
    w = w.to(x.dtype)
    if x.dtype == torch.float32 or x.is_cuda:
        return F.conv2d(x, w, stride=stride, padding=padding)
    return F.conv2d(x.float(), w.float(), stride=stride,
                    padding=padding).to(x.dtype)


def _affine(x: torch.Tensor, bn: Affine) -> torch.Tensor:
    return (x * bn.weight.to(x.dtype)[None, :, None, None]
            + bn.bias.to(x.dtype)[None, :, None, None])


def _avg_pool2(x: torch.Tensor, k: int = 2) -> torch.Tensor:
    B, C, H, W = x.shape
    return x.reshape(B, C, H // k, k, W // k, k).mean(dim=(3, 5))


def _bottleneck(x: torch.Tensor, p: Bottleneck, stride: int
                ) -> torch.Tensor:
    out = F.relu(_affine(_conv(x, p.conv1), p.bn1))
    out = F.relu(_affine(_conv(out, p.conv2, 1, 1), p.bn2))
    if stride > 1:
        out = _avg_pool2(out, stride)
    out = _affine(_conv(out, p.conv3), p.bn3)
    sc = x
    if p.downsample is not None:
        sc = x if stride == 1 else _avg_pool2(x, stride)
        sc = _affine(_conv(sc, p.downsample.conv), p.downsample.bn)
    return F.relu(out + sc)


def _stage(x: torch.Tensor, p: Stage, stride: int) -> torch.Tensor:
    x = _bottleneck(x, p.block0, stride)
    if p.rest is not None:
        for block in p.rest.layers:
            x = _bottleneck(x, block, 1)
    return x


def _attention_pool(x: torch.Tensor, p: AttentionPool,
                    heads: int) -> torch.Tensor:
    """[B, C, H, W] -> [B, output_dim]: the mean token attends over the
    HW + 1 tokens (separate q / k / v projections)."""
    B, C, H, W = x.shape
    t = x.reshape(B, C, H * W).transpose(1, 2)  # [B, HW, C]
    t = torch.cat([t.mean(1, keepdim=True), t], dim=1)
    t = t + p.positional_embedding[None].to(t.dtype)
    q = dense(t[:, :1], p.q_proj.w, p.q_proj.b)  # [B, 1, C]
    k = dense(t, p.k_proj.w, p.k_proj.b)
    v = dense(t, p.v_proj.w, p.v_proj.b)
    dh = C // heads

    def split(z):
        return z.reshape(B, -1, heads, dh).transpose(1, 2)

    q, k, v = split(q), split(k), split(v)
    # products of rounded operands in f32: f32 accumulation
    scores = torch.matmul((q * (dh ** -0.5)).float(),
                          k.float().transpose(-1, -2))
    attn = torch.softmax(scores, dim=-1).to(v.dtype)
    o = torch.matmul(attn.float(), v.float()).to(v.dtype)
    o = o.transpose(1, 2).reshape(B, C)
    return dense(o, p.c_proj.w, p.c_proj.b)


@contextlib.contextmanager
def _ieee_f32(on: bool):
    """TF32 off for cuDNN convolutions and cuBLAS matmuls while an f32
    tower runs on the card; the process's settings come back after."""
    if not on:
        yield
        return
    conv, mm = (torch.backends.cudnn.allow_tf32,
                torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = conv
        torch.backends.cuda.matmul.allow_tf32 = mm


def encode_image_resnet(visual: ResNetVisionTower, images: torch.Tensor,
                        dtype: torch.dtype = torch.float32, *, lora=None,
                        remat: bool = False, keep_tokens=None,
                        tp=None) -> torch.Tensor:
    """[B, 3, S, S] CLIP-normalized images -> [B, output_dim] f32
    features; `remat`, `keep_tokens` and `tp` are ViT options, ignored."""
    assert lora is None, "LoRA targets the ViT attention (lora.py:385)"
    with _ieee_f32(dtype == torch.float32 and images.is_cuda):
        x = images.to(dtype)
        stem = visual.stem
        x = F.relu(_affine(_conv(x, stem.conv1, 2, 1), stem.bn1))
        x = F.relu(_affine(_conv(x, stem.conv2, 1, 1), stem.bn2))
        x = F.relu(_affine(_conv(x, stem.conv3, 1, 1), stem.bn3))
        x = _avg_pool2(x, 2)
        for i in range(4):
            x = _stage(x, getattr(visual, f"layer{i + 1}"),
                       stride=1 if i == 0 else 2)
        return _attention_pool(x, visual.attnpool, visual.cfg.heads).float()


# ---------------------------------------------------------------------------
# initialization
# ---------------------------------------------------------------------------


def _he_(w: torch.Tensor, gen: torch.Generator) -> None:
    _normal_(w, (2.0 / (w.shape[1] * w.shape[2] * w.shape[3])) ** 0.5, gen)


def _init_affine_(bn: Affine) -> None:
    bn.weight.fill_(1.0)
    bn.bias.zero_()


@torch.no_grad()
def init_resnet_visual_(visual: ResNetVisionTower,
                        generator: torch.Generator) -> None:
    """Random weights in place (the JAX package's `init_resnet_visual`
    scheme): He-normal convolutions, identity affines, N(0, 1/in)
    projections with zero biases, N(0, 1/C) positional embedding."""
    modules = [visual.stem] + [
        m for m in visual.modules() if isinstance(m, Bottleneck)]
    for m in modules:
        for name in ("conv1", "conv2", "conv3"):
            _he_(getattr(m, name), generator)
        for name in ("bn1", "bn2", "bn3"):
            _init_affine_(getattr(m, name))
        ds: Optional[Downsample] = getattr(m, "downsample", None)
        if ds is not None:
            _he_(ds.conv, generator)
            _init_affine_(ds.bn)
    pool = visual.attnpool
    C = visual.cfg.embed_dim
    _normal_(pool.positional_embedding, C ** -0.5, generator)
    for lin in (pool.q_proj, pool.k_proj, pool.v_proj, pool.c_proj):
        _normal_(lin.w, lin.w.shape[1] ** -0.5, generator)
        lin.b.zero_()
