"""Multi-head attention, forward and backward, in two layouts.

Port of eventclip_tpu/ops/attention.py:

- `fused_qkv_attention(qkv, heads, mask)`: fused [B, S, 3D] -> [B, S, D]
  (the towers' layout; TPU kernels K2 `_qkv_attention_forward` and, for its
  gradient, K3 `_bwd_kernel` via `_qkv_attention_bwd`);
- `multi_head_attention(q, k, v, mask)`: [B, H, S, dh] each (TPU kernel K4
  `_attention_forward`, gradient K3 via `_attention_bwd`);
- `tp_fused_qkv_attention(qkv, heads, tp, mask)`: one tensor-parallel
  rank's [B, S, 3D/n] (its whole heads of q, k and v) -> [B, S, D/n],
  the fused kernels on heads / n heads; q, k and v are never gathered.

Both go through `torch.library` custom ops (ops/custom_ops.py:
`eventclip::qkv_attention`, `eventclip::attention`, whose registered
gradients are `eventclip::qkv_attention_bwd` / `eventclip::attention_bwd`).
On CUDA tensors the forward launches csrc/attention.cu and the backward
csrc/attention_bwd.cu, each given the layout as element strides, so both
layouts run the same kernels (or raise): bf16 on the wgmma kernels, whose
operands TMA copies through tensor maps (`tma_map`, `stats_map` give
their geometry), f32 on the CUDA-core ones. TMA and the f32 forward's
16-byte copies need every row start 16-byte aligned (checked here for
both dtypes; the f32 backward takes any). On CPU tensors they take
`attention_plain` / `attention_bwd_plain`, the same arithmetic in plain
PyTorch, in the TPU kernels' order.

The additive mask's cotangent is never computed by the kernels: when the
mask needs a gradient it comes from `mask_cotangent` in plain torch, as the
JAX package's `_mask_cotangent` takes it from its XLA backward.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

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


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _on_device(t: torch.Tensor):
    """The CUDA device context of `t` for a launch (a no-op when it is the
    current device already, which saves host time at small shapes)."""
    if t.device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(t.device)


def _strides_bhsd(t: torch.Tensor):
    """(batch, head, row) element strides of a [B, H, S, dh] view."""
    return t.stride(0), t.stride(1), t.stride(2)


def _check_rows_aligned(dtype, layouts):
    """TMA (bf16) and the f32 forward's cp.async copies need every row
    start of every operand 16-byte aligned. The towers' fused [B, S, 3D]
    tensors always are (3D * dh a multiple of 16 bytes at dh 16, 32, 64),
    as are contiguous [B, H, S, dh] ones. layouts: (data pointers, (batch,
    head, row) element strides) pairs."""
    esize = dtype.itemsize
    for ptrs, strides in layouts:
        if any(p % 16 for p in ptrs) or any(s * esize % 16 for s in strides):
            raise ValueError(
                f"{dtype} attention needs 16-byte aligned rows: data pointers "
                f"{[p % 16 for p in ptrs]} bytes past 16, element strides "
                f"{tuple(strides)}")


# -- TMA tensor maps of the bf16 kernels --------------------------------------

TILE_ROWS = 64  # rows of one TMA box: wgmma's m and the kernels' key step


class TmaMap(NamedTuple):
    """The geometry of one rank-4 TMA tensor map (csrc/attention_common.cuh
    `MapGeom`): `dims` in elements, innermost first; `strides` in bytes of
    dims 1-3; the `box` one copy moves; `swizzle` in bytes (0: none)."""
    dims: Tuple[int, int, int, int]
    strides: Tuple[int, int, int]
    box: Tuple[int, int, int, int]
    swizzle: int

    def as_ctypes(self):
        return (ctypes.c_longlong * 12)(*self.dims, *self.strides, *self.box,
                                        self.swizzle)


def tma_map(B: int, S: int, heads: int, dh: int,
            strides: Tuple[int, int, int]) -> TmaMap:
    """The tensor map of one bf16 operand of the wgmma kernels, in any
    layout given as (batch, head, row) element strides: dims (dh, S, heads,
    B), byte strides (row, head, batch), a box of one head's 64 rows, and
    the swizzle of one row (dh * 2 bytes: 32, 64 or 128), which the
    kernels' wgmma descriptors read. One map covers the fused [B, S, 3D]
    layout (a column block and a head's columns), a tensor-parallel rank's
    [B, S, 3D/n] and [B, H, S, dh]; TMA reads rows past S (and the ragged
    last box) as zeros, never the next batch's rows."""
    if dh not in _HEAD_DIMS:
        raise ValueError(f"head dim {dh} not in {_HEAD_DIMS}")
    batch, head, row = (2 * s for s in strides)
    if any(s % 16 for s in (row, head, batch)):
        raise ValueError(
            f"TMA strides must be 16-byte multiples, got {row}, {head} and "
            f"{batch} bytes (row, head, batch)")
    return TmaMap(dims=(dh, S, heads, B), strides=(row, head, batch),
                  box=(dh, TILE_ROWS, 1, 1), swizzle=2 * dh)


def stats_rows(S: int) -> int:
    """The rows of one head in the backward's statistics scratch: S rounded
    up to a whole box."""
    return -(-S // TILE_ROWS) * TILE_ROWS


def stats_map(bh: int, S: int) -> TmaMap:
    """The tensor map of the bf16 backward's f32 statistics scratch, [3,
    bh, stats_rows(S)] (the row max, 1 / sum and delta of every query row,
    written by the dq kernel): a box is one head's 64 rows of all three."""
    sp = stats_rows(S)
    return TmaMap(dims=(sp, bh, 3, 1), strides=(4 * sp, 4 * bh * sp,
                                                12 * bh * sp),
                  box=(TILE_ROWS, 1, 3, 1), swizzle=0)


def ring_plan(S: int, dh: int, device=None) -> dict:
    """How the bf16 kernels hold one head of S rows on the card: each
    kernel's ring slots, the 64-row chunks of its streamed operands, and
    whether they are resident (every chunk in shared memory, copied once a
    block) or streamed through the ring; the forward's plan first, then
    the backward's dq and dk/dv kernels'. Asks the built libraries (the
    rule reads the card's shared memory and the build's warpgroups)."""
    out = (ctypes.c_int * 5)()
    plans = {}
    for name, fn, kinds in (("attention", "attention_fwd_plan", ("fwd",)),
                            ("attention_bwd", "attention_bwd_plan",
                             ("dq", "dkdv"))):
        lib = kernels.library(name)
        with torch.cuda.device(device):
            kernels.check(lib, getattr(lib, fn)(S, dh, out), fn)
        chunks = out[1] if name == "attention" else out[2]
        for i, kind in enumerate(kinds):
            slots = out[0] if name == "attention" else out[i]
            smem = out[2] if name == "attention" else out[3 + i]
            plans[kind] = dict(slots=slots, chunks=chunks, smem=smem,
                               resident=slots >= chunks)
    return plans


@functools.lru_cache(maxsize=256)
def _map_arg(B, S, heads, dh, strides):
    """tma_map's geometry as the launchers' ctypes argument, built once a
    shape (a launch costs host time that the small shapes feel)."""
    return tma_map(B, S, heads, dh, strides).as_ctypes()


@functools.lru_cache(maxsize=256)
def _stats_arg(bh, S):
    return stats_map(bh, S).as_ctypes()


def _launch_fwd(ptrs, mask, out, B, S, heads, dh, in_strides,
                out_strides):
    """ptrs: data pointers of q, k, v."""
    _check_rows_aligned(out.dtype, [(ptrs, in_strides),
                                    ((out.data_ptr(),), out_strides)])
    geoms = (None, None)
    if out.dtype == torch.bfloat16:
        geoms = (_map_arg(B, S, heads, dh, tuple(in_strides)),
                 _map_arg(B, S, heads, dh, tuple(out_strides)))
    lib = kernels.library("attention")
    with _on_device(out):
        rc = lib.attention_fwd(
            *ptrs, None if mask is None else mask.data_ptr(), out.data_ptr(),
            B, S, heads, dh, *in_strides, *out_strides,
            _DTYPE_CODE[out.dtype], dh ** -0.5, _stream(out), *geoms)
    kernels.check(lib, rc, "attention_fwd")


def _launch_bwd(ptrs, mask, g, B, S, heads, dh, in_strides, g_strides):
    """ptrs: data pointers of q, k, v, dq, dk, dv."""
    geoms = (None, None, None)
    if g.dtype == torch.bfloat16:  # the f32 backward copies 4 bytes at a time
        _check_rows_aligned(g.dtype, [(ptrs, in_strides),
                                      ((g.data_ptr(),), g_strides)])
        geoms = (_map_arg(B, S, heads, dh, tuple(in_strides)),
                 _map_arg(B, S, heads, dh, tuple(g_strides)),
                 _stats_arg(B * heads, S))
    stats = torch.empty(3 * B * heads * stats_rows(S), dtype=torch.float32,
                        device=g.device)
    q, k, v, dq, dk, dv = ptrs
    lib = kernels.library("attention_bwd")
    with _on_device(g):
        rc = lib.attention_bwd(
            q, k, v, g.data_ptr(), None if mask is None else mask.data_ptr(),
            dq, dk, dv, stats.data_ptr(), B, S, heads, dh, *in_strides,
            *g_strides, _DTYPE_CODE[g.dtype], dh ** -0.5, _stream(g), *geoms)
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


def launch_qkv_attention(qkv: torch.Tensor, heads: int,
                         mask: Optional[torch.Tensor]) -> torch.Tensor:
    """K2 on a checked CUDA [B, S, 3D] tensor -> [B, S, D] (the CUDA
    implementation of `eventclip::qkv_attention`)."""
    B, S, D3 = qkv.shape
    D = D3 // 3
    out = torch.empty((B, S, D), dtype=qkv.dtype, device=qkv.device)
    dh = D // heads
    _launch_fwd(_column_blocks(qkv), mask, out, B, S, heads, dh,
                (S * D3, dh, D3), (S * D, dh, D))
    kernels.LAUNCHES["qkv_attention"] += 1
    return out


def launch_qkv_attention_bwd(qkv: torch.Tensor, g: torch.Tensor, heads: int,
                             mask: Optional[torch.Tensor]) -> torch.Tensor:
    """K3 on checked CUDA tensors in the fused layout -> [B, S, 3D] (the
    CUDA implementation of `eventclip::qkv_attention_bwd`)."""
    B, S, D3 = qkv.shape
    D = D3 // 3
    dqkv = torch.empty_like(qkv)
    dh = D // heads
    _launch_bwd(_column_blocks(qkv) + _column_blocks(dqkv), mask, g, B, S,
                heads, dh, (S * D3, dh, D3), (S * D, dh, D))
    kernels.LAUNCHES["qkv_attention_bwd"] += 1
    return dqkv


def qkv_attention_bwd(qkv: torch.Tensor, g: torch.Tensor, heads: int,
                      mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K3 in the fused layout: [B, S, 3D] qkv + [B, S, D] output gradient
    -> [B, S, 3D] qkv gradient, through `eventclip::qkv_attention_bwd`:
    CUDA tensors run the kernel (or raise); CPU tensors run
    `qkv_attention_bwd_plain`."""
    _check_qkv(qkv, heads, mask)
    B, S, D3 = qkv.shape
    D = D3 // 3
    if g.shape != (B, S, D) or g.dtype != qkv.dtype or g.device != qkv.device:
        raise ValueError(f"g must be {qkv.dtype} [{B}, {S}, {D}] on "
                         f"{qkv.device}, got {g.dtype} {tuple(g.shape)}")
    return torch.ops.eventclip.qkv_attention_bwd(qkv, g.contiguous(), heads,
                                                 mask)


def fused_qkv_attention(qkv: torch.Tensor, heads: int,
                        mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[B, S, 3D] fused qkv (+ optional f32 [S, S] mask) -> [B, S, D]
    through `eventclip::qkv_attention`, differentiable: its registered
    gradient runs K3.

    CUDA tensors run the kernels (or raise); CPU tensors run the plain
    versions."""
    _check_qkv(qkv, heads, mask)
    return torch.ops.eventclip.qkv_attention(qkv, heads, mask)


def tp_fused_qkv_attention(qkv: torch.Tensor, heads: int, tp,
                           mask: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Tensor-parallel attention on one rank (the JAX package's
    `tp_fused_qkv_attention`): `qkv` is this rank's [B, S, 3·D/n] of the
    fused projection, [q_r | k_r | v_r] (parallel/sharding.py cuts `wqkv`
    so), and the fused kernel runs on its heads / n heads; the output
    [B, S, D/n] stays sharded for the row-parallel out-projection. The
    additive [S, S] mask is per position, so it applies unchanged to the
    local heads."""
    n = tp.n_model
    if heads % n:
        raise AssertionError(f"({heads}, {n}): {heads} heads do not split "
                             f"over a model axis of {n}")
    return fused_qkv_attention(qkv, heads // n, mask)


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


def launch_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     mask: Optional[torch.Tensor]) -> torch.Tensor:
    """K4 on checked CUDA [B, H, S, dh] tensors (the CUDA implementation
    of `eventclip::attention`)."""
    out = torch.empty_like(q)
    B, H, S, dh = q.shape
    _launch_fwd((q.data_ptr(), k.data_ptr(), v.data_ptr()), mask, out, B, S,
                H, dh, _strides_bhsd(q), _strides_bhsd(out))
    kernels.LAUNCHES["attention"] += 1
    return out


def launch_attention_bwd(q, k, v, g, mask):
    """K3 on checked CUDA tensors in the [B, H, S, dh] layout -> (dq, dk,
    dv) (the CUDA implementation of `eventclip::attention_bwd`)."""
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    B, H, S, dh = q.shape
    _launch_bwd((q.data_ptr(), k.data_ptr(), v.data_ptr(), dq.data_ptr(),
                 dk.data_ptr(), dv.data_ptr()), mask, g, B, S, H, dh,
                _strides_bhsd(q), _strides_bhsd(g))
    kernels.LAUNCHES["qkv_attention_bwd"] += 1
    return dq, dk, dv


def attention_bwd(q, k, v, g, mask=None):
    """K3 in the [B, H, S, dh] layout -> (dq, dk, dv), through
    `eventclip::attention_bwd`: CUDA tensors run the kernel (or raise); CPU
    tensors run `attention_bwd_plain`."""
    _check_bhsd(q, k, v, mask)
    if g.shape != q.shape or g.dtype != q.dtype or g.device != q.device:
        raise ValueError(f"g must be {q.dtype} {tuple(q.shape)} on "
                         f"{q.device}, got {g.dtype} {tuple(g.shape)}")
    return torch.ops.eventclip.attention_bwd(q, k, v, g.contiguous(), mask)


def multi_head_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[B, H, S, dh] q/k/v (+ optional f32 [S, S] additive mask) ->
    [B, H, S, dh] through `eventclip::attention`, differentiable: its
    registered gradient runs K3.

    CUDA tensors run the kernels (or raise); CPU tensors run the plain
    versions."""
    _check_bhsd(q, k, v, mask)
    return torch.ops.eventclip.attention(q, k, v, mask)
