"""The primitives every CLIP tower is built from: the product `dense`
(its card route and autograd), Megatron's column- and row-parallel
products, the f32 layer norm, the LoRA delta, the causal mask and the
parameter helpers, each with its rounding rule (the JAX package's). The
towers (models/clip/{model,eva,resnet}.py) and models/adapter.py import
them from here; this module imports no tower.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.dense import dense_bf16
from ...ops.quant import AmaxRecorder, QWeight, qdense
from ...parallel.distributed import model_all_reduce_sum_


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


def lora_delta(x: torch.Tensor, a: torch.Tensor,
               b: torch.Tensor) -> torch.Tensor:
    """Low-rank delta (x A^T) B^T; A [r, in], B [out, r], each product
    rounded to x's dtype (the JAX package's `_lora_delta`)."""
    return dense(dense(x, a), b)


def causal_mask(T: int, device=None) -> torch.Tensor:
    """Additive [T, T] f32 mask, -inf above the diagonal."""
    return torch.full((T, T), float("-inf"), device=device).triu(1)


def _param(*shape, zeros: bool = False, device=None) -> nn.Parameter:
    return nn.Parameter((torch.zeros if zeros else torch.empty)(
        *shape, device=device))


def _normal_(p: torch.Tensor, std: float, gen: torch.Generator) -> None:
    p.copy_(torch.randn(p.shape, generator=gen, device=gen.device) * std)
