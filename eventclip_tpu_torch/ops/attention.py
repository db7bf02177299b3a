"""Multi-head attention, forward and backward, in two layouts.

Port of eventclip_tpu/ops/attention.py:

- `fused_qkv_attention(qkv, heads, mask)`: fused [B, S, 3D] -> [B, S, D]
  (the towers' layout; TPU kernels K2 `_qkv_attention_forward` and, for its
  gradient, K3 `_bwd_kernel` via `_qkv_attention_bwd`);
- `multi_head_attention(q, k, v, mask)`: [B, H, S, dh] each (TPU kernel K4
  `_attention_forward`, gradient K3 via `_attention_bwd`).

Both are `torch.autograd.Function`s. On CUDA tensors the forward launches
csrc/attention.cu and the backward csrc/attention_bwd.cu, each given the
layout as element strides, so both layouts run the same kernels (or
raise): bf16 on the tensor-core kernels, f32 on the CUDA-core ones. The
forward kernels copy 16-byte pieces and so need every row start 16-byte
aligned (checked here for both dtypes; the f32 backward takes any). On CPU
tensors they take `attention_plain` /
`attention_bwd_plain`, the same arithmetic in plain PyTorch, in the TPU
kernels' order.

The additive mask's cotangent is never computed by the kernels: when the
mask needs a gradient it comes from `mask_cotangent` in plain torch, as the
JAX package's `_mask_cotangent` takes it from its XLA backward.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .. import kernels

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (16, 32, 64)


# -- plain versions, [B, H, S, dh] --------------------------------------------


def _probs(q, k, mask, scale):
    """f32 softmax(q . k^T * scale + mask), the scale applied after the dot
    and the softmax taken over the whole row."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if mask is not None:
        s = s + mask.float()
    p = torch.exp(s - s.amax(-1, keepdim=True))
    return p / p.sum(-1, keepdim=True)


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[B, H, S, dh] q, k, v (+ f32 [S, S] additive mask) -> [B, H, S, dh],
    in the TPU kernel's order: f32 scores scaled after the dot, full-row
    softmax, p rounded to the input dtype before p @ v, f32 accumulation."""
    p = _probs(q, k, mask, q.shape[-1] ** -0.5).to(q.dtype)
    return torch.matmul(p.float(), v.float()).to(q.dtype)


def attention_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        g: torch.Tensor, mask: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The recompute backward of `attention_plain` -> (dq, dk, dv), in the
    TPU kernel's order (`_bwd_kernel`): p recomputed in f32; dv = round(p)^T
    g; dp = g v^T in f32; ds = p (dp - rowsum(dp p)) with the unrounded p;
    ds * scale rounded to the input dtype; dq = ds k, dk = ds^T q, all
    products summed in f32 and rounded to the input dtype."""
    dt = q.dtype
    scale = q.shape[-1] ** -0.5
    p = _probs(q, k, mask, scale)
    gf = g.float()
    dv = torch.matmul(p.to(dt).float().transpose(-1, -2), gf)
    dp = torch.matmul(gf, v.float().transpose(-1, -2))
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    ds = (ds * scale).to(dt).float()
    dq = torch.matmul(ds, k.float())
    dk = torch.matmul(ds.transpose(-1, -2), q.float())
    return dq.to(dt), dk.to(dt), dv.to(dt)


def mask_cotangent(q, k, v, mask, g) -> torch.Tensor:
    """dL/dmask [S, S] of `attention_plain`, summed over batch and heads —
    the JAX package's `_mask_cotangent` (its XLA backward: q scaled before
    the dot, p unrounded)."""
    scale = q.shape[-1] ** -0.5
    s = torch.matmul((q * scale).float(), k.float().transpose(-1, -2))
    s = s + mask.float()
    p = torch.softmax(s, dim=-1)
    dp = torch.matmul(g.float(), v.float().transpose(-1, -2))
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    return ds.sum((0, 1)).to(mask.dtype)


# -- layouts -----------------------------------------------------------------


def _split_heads(qkv: torch.Tensor, heads: int):
    """[B, S, 3D] -> q, k, v [B, H, S, dh] (views)."""
    B, S, D3 = qkv.shape
    D = D3 // 3

    def split(t):
        return t.reshape(B, S, heads, D // heads).transpose(1, 2)

    return tuple(split(t) for t in qkv.split(D, dim=-1))


def _merge_heads(t: torch.Tensor) -> torch.Tensor:
    """[B, H, S, dh] -> [B, S, H*dh]."""
    B, H, S, dh = t.shape
    return t.transpose(1, 2).reshape(B, S, H * dh)


def qkv_attention_plain(qkv: torch.Tensor, heads: int,
                        mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[B, S, 3D] (+ f32 [S, S] additive mask) -> [B, S, D]: the plain
    version of K2."""
    return _merge_heads(attention_plain(*_split_heads(qkv, heads), mask))


def qkv_attention_bwd_plain(qkv: torch.Tensor, g: torch.Tensor, heads: int,
                            mask: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """[B, S, 3D] qkv and [B, S, D] output gradient -> the [B, S, 3D] qkv
    gradient: the plain version of K3 in the fused layout."""
    B, S, D3 = qkv.shape
    gh = g.reshape(B, S, heads, D3 // 3 // heads).transpose(1, 2)
    grads = attention_bwd_plain(*_split_heads(qkv, heads), gh, mask)
    return torch.cat([_merge_heads(t) for t in grads], dim=-1)


# -- kernel launchers ----------------------------------------------------------


def _check_dtype_and_dh(t: torch.Tensor, dh: int):
    if dh not in _HEAD_DIMS:
        raise ValueError(f"head dim {dh} not in {_HEAD_DIMS}")
    if t.dtype not in _DTYPE_CODE:
        raise TypeError(f"dtype {t.dtype} not in {list(_DTYPE_CODE)}")


def _check_mask(mask: Optional[torch.Tensor], S: int, device):
    if mask is not None and (
            mask.shape != (S, S) or mask.dtype != torch.float32
            or mask.device != device or not mask.is_contiguous()):
        raise ValueError(
            f"mask must be a contiguous float32 [{S}, {S}] tensor on "
            f"{device}, got {mask.dtype} {tuple(mask.shape)} on {mask.device}")


def _cuda_only(t: torch.Tensor):
    if t.device.type != "cuda":
        raise ValueError(f"unsupported device {t.device}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _strides_bhsd(t: torch.Tensor):
    """(batch, head, row) element strides of a [B, H, S, dh] view."""
    return t.stride(0), t.stride(1), t.stride(2)


def _check_rows_aligned(dtype, layouts):
    """Both kernels' cp.async copies move 16 bytes: every row start of
    every operand must be 16-byte aligned. The towers' fused [B, S, 3D]
    tensors always are (3D * dh a multiple of 16 bytes at dh 16, 32, 64),
    as are contiguous [B, H, S, dh] ones. layouts: (data pointers, (batch,
    head, row) element strides) pairs."""
    esize = torch.tensor([], dtype=dtype).element_size()
    for ptrs, strides in layouts:
        if any(p % 16 for p in ptrs) or any(s * esize % 16 for s in strides):
            raise ValueError(
                f"{dtype} attention needs 16-byte aligned rows: data pointers "
                f"{[p % 16 for p in ptrs]} bytes past 16, element strides "
                f"{tuple(strides)}")


def _launch_fwd(ptrs, mask, out, B, S, heads, dh, in_strides,
                out_strides):
    """ptrs: data pointers of q, k, v."""
    _check_rows_aligned(out.dtype, [(ptrs, in_strides),
                                    ((out.data_ptr(),), out_strides)])
    lib = kernels.library("attention")
    with torch.cuda.device(out.device):
        rc = lib.attention_fwd(
            *ptrs, None if mask is None else mask.data_ptr(), out.data_ptr(),
            B, S, heads, dh, *in_strides, *out_strides,
            _DTYPE_CODE[out.dtype], dh ** -0.5, _stream(out))
    kernels.check(lib, rc, "attention_fwd")


def _launch_bwd(ptrs, mask, g, B, S, heads, dh, in_strides, g_strides):
    """ptrs: data pointers of q, k, v, dq, dk, dv."""
    if g.dtype == torch.bfloat16:  # the f32 backward copies 4 bytes at a time
        _check_rows_aligned(g.dtype, [(ptrs, in_strides),
                                      ((g.data_ptr(),), g_strides)])
    stats = torch.empty(3 * B * heads * S, dtype=torch.float32,
                        device=g.device)
    q, k, v, dq, dk, dv = ptrs
    lib = kernels.library("attention_bwd")
    with torch.cuda.device(g.device):
        rc = lib.attention_bwd(
            q, k, v, g.data_ptr(), None if mask is None else mask.data_ptr(),
            dq, dk, dv, stats.data_ptr(), B, S, heads, dh, *in_strides,
            *g_strides, _DTYPE_CODE[g.dtype], dh ** -0.5, _stream(g))
    kernels.check(lib, rc, "attention_bwd")


# -- fused [B, S, 3D] layout (K2 forward, K3 backward) ------------------------


def _column_blocks(t: torch.Tensor):
    """Data pointers of the q, k and v column blocks of a [B, S, 3D]
    tensor."""
    step = t.shape[-1] // 3 * t.element_size()
    return tuple(t.data_ptr() + i * step for i in range(3))


def _check_qkv(qkv: torch.Tensor, heads: int, mask: Optional[torch.Tensor]):
    if qkv.dim() != 3 or qkv.shape[-1] % 3:
        raise ValueError(f"expected qkv [B, S, 3D], got {tuple(qkv.shape)}")
    D = qkv.shape[-1] // 3
    if D % heads:
        raise ValueError(f"width {D} does not split into {heads} heads")
    _check_dtype_and_dh(qkv, D // heads)
    if not qkv.is_contiguous():
        raise ValueError("qkv must be contiguous")
    _check_mask(mask, qkv.shape[1], qkv.device)


def _qkv_forward(qkv, heads, mask):
    """K2: the kernel on a CUDA tensor, the plain version on a CPU one."""
    if qkv.device.type == "cpu":
        return qkv_attention_plain(qkv, heads, mask)
    _cuda_only(qkv)
    B, S, D3 = qkv.shape
    D = D3 // 3
    out = torch.empty((B, S, D), dtype=qkv.dtype, device=qkv.device)
    dh = D // heads
    _launch_fwd(_column_blocks(qkv), mask, out, B, S, heads, dh,
                (S * D3, dh, D3), (S * D, dh, D))
    kernels.LAUNCHES["qkv_attention"] += 1
    return out


def qkv_attention_bwd(qkv: torch.Tensor, g: torch.Tensor, heads: int,
                      mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K3 in the fused layout: [B, S, 3D] qkv + [B, S, D] output gradient
    -> [B, S, 3D] qkv gradient. CUDA tensors run the kernel (or raise); CPU
    tensors run `qkv_attention_bwd_plain`."""
    _check_qkv(qkv, heads, mask)
    B, S, D3 = qkv.shape
    D = D3 // 3
    if g.shape != (B, S, D) or g.dtype != qkv.dtype or g.device != qkv.device:
        raise ValueError(f"g must be {qkv.dtype} [{B}, {S}, {D}] on "
                         f"{qkv.device}, got {g.dtype} {tuple(g.shape)}")
    g = g.contiguous()
    if qkv.device.type == "cpu":
        return qkv_attention_bwd_plain(qkv, g, heads, mask)
    _cuda_only(qkv)
    dqkv = torch.empty_like(qkv)
    dh = D // heads
    _launch_bwd(_column_blocks(qkv) + _column_blocks(dqkv), mask, g, B, S,
                heads, dh, (S * D3, dh, D3), (S * D, dh, D))
    kernels.LAUNCHES["qkv_attention_bwd"] += 1
    return dqkv


class _QKVAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qkv, mask, heads):
        ctx.heads = heads
        ctx.save_for_backward(qkv, mask)
        return _qkv_forward(qkv, heads, mask)

    @staticmethod
    def backward(ctx, g):
        qkv, mask = ctx.saved_tensors
        dqkv = qkv_attention_bwd(qkv, g.to(qkv.dtype), ctx.heads, mask)
        dmask = None
        if ctx.needs_input_grad[1]:
            B, S, D3 = qkv.shape
            gh = g.reshape(B, S, ctx.heads, -1).transpose(1, 2)
            dmask = mask_cotangent(*_split_heads(qkv, ctx.heads), mask, gh)
        return dqkv, dmask, None


def fused_qkv_attention(qkv: torch.Tensor, heads: int,
                        mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[B, S, 3D] fused qkv (+ optional f32 [S, S] mask) -> [B, S, D],
    differentiable: the gradient runs K3.

    CUDA tensors run the kernels (or raise); CPU tensors run the plain
    versions."""
    _check_qkv(qkv, heads, mask)
    return _QKVAttention.apply(qkv, mask, heads)


# -- [B, H, S, dh] layout (K4 forward, K3 backward) ---------------------------


def _check_bhsd(q, k, v, mask):
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError("expected q, k, v of one [B, H, S, dh] shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    _check_dtype_and_dh(q, q.shape[-1])
    for t in (q, k, v):
        if t.dtype != q.dtype or t.device != q.device:
            raise ValueError("q, k and v must share a dtype and a device")
        if not t.is_contiguous():
            raise ValueError("q, k and v must be contiguous")
    _check_mask(mask, q.shape[2], q.device)


def _bhsd_forward(q, k, v, mask):
    """K4: the kernel on CUDA tensors, the plain version on CPU ones."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v, mask)
    _cuda_only(q)
    out = torch.empty_like(q)
    B, H, S, dh = q.shape
    _launch_fwd((q.data_ptr(), k.data_ptr(), v.data_ptr()), mask, out, B, S,
                H, dh, _strides_bhsd(q), _strides_bhsd(out))
    kernels.LAUNCHES["attention"] += 1
    return out


def attention_bwd(q, k, v, g, mask=None):
    """K3 in the [B, H, S, dh] layout -> (dq, dk, dv). CUDA tensors run the
    kernel (or raise); CPU tensors run `attention_bwd_plain`."""
    _check_bhsd(q, k, v, mask)
    if g.shape != q.shape or g.dtype != q.dtype or g.device != q.device:
        raise ValueError(f"g must be {q.dtype} {tuple(q.shape)} on "
                         f"{q.device}, got {g.dtype} {tuple(g.shape)}")
    g = g.contiguous()
    if q.device.type == "cpu":
        return attention_bwd_plain(q, k, v, g, mask)
    _cuda_only(q)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    B, H, S, dh = q.shape
    _launch_bwd((q.data_ptr(), k.data_ptr(), v.data_ptr(), dq.data_ptr(),
                 dk.data_ptr(), dv.data_ptr()), mask, g, B, S, H, dh,
                _strides_bhsd(q), _strides_bhsd(g))
    kernels.LAUNCHES["qkv_attention_bwd"] += 1
    return dq, dk, dv


class _Attention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, mask):
        ctx.save_for_backward(q, k, v, mask)
        return _bhsd_forward(q, k, v, mask)

    @staticmethod
    def backward(ctx, g):
        q, k, v, mask = ctx.saved_tensors
        g = g.to(q.dtype)
        dq, dk, dv = attention_bwd(q, k, v, g, mask)
        dmask = (mask_cotangent(q, k, v, mask, g)
                 if ctx.needs_input_grad[3] else None)
        return dq, dk, dv, dmask


def multi_head_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[B, H, S, dh] q/k/v (+ optional f32 [S, S] additive mask) ->
    [B, H, S, dh], differentiable: the gradient runs K3.

    CUDA tensors run the kernels (or raise); CPU tensors run the plain
    versions."""
    _check_bhsd(q, k, v, mask)
    return _Attention.apply(q, k, v, mask)
