"""The hand-written kernels as `torch.library` custom ops.

K1 (csrc/histogram.cu), K2 / K4 (csrc/attention.cu), K3
(csrc/attention_bwd.cu), D1 (csrc/dense.cu), the rotary kernel
(csrc/rope.cu) and S1, EVA02's SwiGLU glue (csrc/swiglu.cu), are
registered here, so that eager training, serving and `torch.export`
(export.py) all launch the same registered op:

- `eventclip::event_histogram(windows, height, width)` (K1);
- `eventclip::qkv_attention(qkv, heads, mask)` (K2, fused [B, S, 3D]);
- `eventclip::attention(q, k, v, mask)` (K4, [B, H, S, dh], K2's launcher);
- `eventclip::qkv_attention_bwd` / `eventclip::attention_bwd` (K3), the
  registered autograd formulas of the two attention ops;
- `eventclip::dense_bf16(x2, w, b)` (D1, the bf16 product of `dense`; its
  CUDA implementation keeps the library GEMM for the shapes D1 does not
  take, ops/dense.py `d1_takes`). Its gradient is `dense`'s autograd
  Function (models/clip/layers.py `_DenseF32Acc`), not registered here;
- `eventclip::rope_qkv(qkv, cos, sin, heads)` (EVA02's 2-D rotary q/k,
  ops/rope.py), which writes `qkv` in place and has no gradient;
- `eventclip::swiglu_ln(h12, weight, bias, eps)` (S1, EVA02's SiLU(gate) *
  value and `ffn_ln` over the real hidden columns, the pad columns 0,
  ops/swiglu.py), which has no gradient.

Each op has a CUDA implementation (the ctypes launch of its kernel, which
counts `kernels.LAUNCHES`), a CPU implementation (its plain PyTorch
version) and a fake implementation (shapes only) for tracing. No switch
takes a CUDA tensor to a plain version: a traced graph keeps each op as
one node, which dispatches on its inputs' device when the graph runs. The
histogram's launch plan depends on the card's shared memory and is chosen
inside the CUDA implementation at run time, so no card-specific number is
baked into a traced graph. No op but `rope_qkv`
mutates an argument, and none aliases one. Argument checks stay in the public
wrappers (ops/attention.py, ops/rasterize.py, ops/rope.py, ops/swiglu.py),
which call these ops.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import Tensor

from . import attention as A
from . import dense as DN
from . import rasterize as R
from . import rope as RP
from . import swiglu as SW

# -- K1 ------------------------------------------------------------------------


@torch.library.custom_op("eventclip::event_histogram", mutates_args=(),
                         device_types="cpu")
def event_histogram(windows: Tensor, height: int, width: int) -> Tensor:
    return R.histograms_plain(windows, height, width)


@event_histogram.register_kernel("cuda")
def _(windows, height, width):
    plan = R.device_histogram_plan(windows.device, height, width)
    return R.launch_histograms(windows, height, width, plan)


@event_histogram.register_fake
def _(windows, height, width):
    return windows.new_empty((windows.shape[0], 2, height, width),
                             dtype=torch.float32)


# -- K2 and its gradient K3, fused [B, S, 3D] ---------------------------------


@torch.library.custom_op("eventclip::qkv_attention", mutates_args=(),
                         device_types="cpu")
def qkv_attention(qkv: Tensor, heads: int, mask: Optional[Tensor]) -> Tensor:
    return A.qkv_attention_plain(qkv, heads, mask)


qkv_attention.register_kernel("cuda")(A.launch_qkv_attention)


@qkv_attention.register_fake
def _(qkv, heads, mask):
    B, S, D3 = qkv.shape
    return qkv.new_empty((B, S, D3 // 3))


@torch.library.custom_op("eventclip::qkv_attention_bwd", mutates_args=(),
                         device_types="cpu")
def qkv_attention_bwd(qkv: Tensor, g: Tensor, heads: int,
                      mask: Optional[Tensor]) -> Tensor:
    return A.qkv_attention_bwd_plain(qkv, g, heads, mask)


qkv_attention_bwd.register_kernel("cuda")(A.launch_qkv_attention_bwd)


@qkv_attention_bwd.register_fake
def _(qkv, g, heads, mask):
    return torch.empty_like(qkv)


def _qkv_setup(ctx, inputs, output):
    qkv, heads, mask = inputs
    ctx.heads = heads
    ctx.save_for_backward(qkv, mask)


def _qkv_backward(ctx, g):
    qkv, mask = ctx.saved_tensors
    dqkv = A.qkv_attention_bwd(qkv, g.to(qkv.dtype), ctx.heads, mask)
    dmask = None
    if ctx.needs_input_grad[2]:
        B, S, _ = qkv.shape
        gh = g.reshape(B, S, ctx.heads, -1).transpose(1, 2)
        dmask = A.mask_cotangent(*A._split_heads(qkv, ctx.heads), mask, gh)
    return dqkv, None, dmask


qkv_attention.register_autograd(_qkv_backward, setup_context=_qkv_setup)


# -- K4 and its gradient K3, [B, H, S, dh] ------------------------------------


@torch.library.custom_op("eventclip::attention", mutates_args=(),
                         device_types="cpu")
def attention(q: Tensor, k: Tensor, v: Tensor,
              mask: Optional[Tensor]) -> Tensor:
    return A.attention_plain(q, k, v, mask)


attention.register_kernel("cuda")(A.launch_attention)


@attention.register_fake
def _(q, k, v, mask):
    return torch.empty_like(q)


@torch.library.custom_op("eventclip::attention_bwd", mutates_args=(),
                         device_types="cpu")
def attention_bwd(q: Tensor, k: Tensor, v: Tensor, g: Tensor,
                  mask: Optional[Tensor]) -> Tuple[Tensor, Tensor, Tensor]:
    return A.attention_bwd_plain(q, k, v, g, mask)


attention_bwd.register_kernel("cuda")(A.launch_attention_bwd)


@attention_bwd.register_fake
def _(q, k, v, g, mask):
    return tuple(torch.empty_like(q) for _ in range(3))


def _bhsd_setup(ctx, inputs, output):
    ctx.save_for_backward(*inputs)


def _bhsd_backward(ctx, g):
    q, k, v, mask = ctx.saved_tensors
    g = g.to(q.dtype)
    dq, dk, dv = A.attention_bwd(q, k, v, g, mask)
    dmask = (A.mask_cotangent(q, k, v, mask, g)
             if ctx.needs_input_grad[3] else None)
    return dq, dk, dv, dmask


attention.register_autograd(_bhsd_backward, setup_context=_bhsd_setup)


# -- D1, the bf16 dense product -----------------------------------------------


@torch.library.custom_op("eventclip::dense_bf16", mutates_args=(),
                         device_types="cpu")
def dense_bf16(x2: Tensor, w: Tensor, b: Optional[Tensor]) -> Tensor:
    return DN.dense_plain(x2, w, b)


dense_bf16.register_kernel("cuda")(DN.launch_dense)


@dense_bf16.register_fake
def _(x2, w, b):
    return x2.new_empty((x2.shape[0], w.shape[0]))


# -- the rotary positions of EVA02's q and k, in place -------------------------


@torch.library.custom_op("eventclip::rope_qkv", mutates_args=("qkv",),
                         device_types="cpu")
def rope_qkv(qkv: Tensor, cos: Tensor, sin: Tensor, heads: int) -> None:
    RP.rope_qkv_plain(qkv, cos, sin, heads)


rope_qkv.register_kernel("cuda")(RP.launch_rope_qkv)


@rope_qkv.register_fake
def _(qkv, cos, sin, heads):
    return None


# -- S1, EVA02's SwiGLU glue ---------------------------------------------------


@torch.library.custom_op("eventclip::swiglu_ln", mutates_args=(),
                         device_types="cpu")
def swiglu_ln(h12: Tensor, weight: Tensor, bias: Tensor,
              eps: float) -> Tensor:
    return SW.swiglu_plain(h12, weight, bias, eps)


swiglu_ln.register_kernel("cuda")(SW.launch_swiglu_ln)


@swiglu_ln.register_fake
def _(h12, weight, bias, eps):
    return h12.new_empty((*h12.shape[:-1], h12.shape[-1] // 2))
