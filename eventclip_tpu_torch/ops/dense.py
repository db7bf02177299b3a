"""The bf16 dense product, D1 (csrc/dense.cu): bf16(x @ w.T + b).

`dense_bf16(x2, w, b)` takes x2 [M, K] and w [N, K] in bf16 and an
optional f32 bias [N]: the products summed in f32, the f32 bias added to
that sum, one rounding to bf16, the arithmetic of the JAX package's
`dense` (models/clip/model.py `dense` calls it for every bf16 product on
the card). It goes through the `torch.library` custom op
`eventclip::dense_bf16` (ops/custom_ops.py):

- on CUDA tensors the op launches D1 for every product that
  `d1_takes`: TMA needs 16-byte rows, so K and N are multiples of 8. A
  product outside that rule (ViT-L/14's patch embedding, K = 588) keeps
  the library GEMM that writes its f32 accumulator, with the bias added
  there, rounded after it (`library_dense`): the same sum;
- on CPU tensors it takes `dense_plain`, the f32 product of the bf16
  operands (exact in f32) plus the f32 bias, rounded once.

The tile plan (`dense_plan`) adapts to the shape and the card's SMs; no
argument, environment variable or fallback chooses a route.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from .. import kernels
from .attention import _on_device, _stream

TILE_ROWS = 128  # rows of a D1 output tile (two consumer warpgroups)
TILE_WIDTHS = (256, 128)  # its columns: the wider unless the narrower's
# rounds are at least a tenth shorter (NARROW_GAIN)
NARROW_GAIN = (9, 10)


def d1_takes(dtype: torch.dtype, n: int, k: int) -> bool:
    """Whether D1 computes a product of `dtype` with n output features and
    k input features: bf16, with 16-byte rows of w, x (k) and out (n)."""
    return (dtype == torch.bfloat16 and n > 0 and k > 0
            and (2 * n) % 16 == 0 and (2 * k) % 16 == 0)


def _tiles(m: int, n: int, width: int) -> int:
    return -(-m // TILE_ROWS) * -(-n // width)


def dense_plan(m: int, n: int, sms: int) -> Tuple[int, int]:
    """(tile width, persistent blocks) of D1 for an [m, n] output on a card
    of `sms` SMs. The persistent blocks take the tiles in rounds of `sms`,
    the last one ragged, so a plan costs about its rounds times its width.
    The 128 x 256 tile is the default: the 128 x 128 one reads a third more
    operand bytes an operation, and ran 10-31% slower on an H100 at the
    serving and FT products with N or K of 3072-4096 (kernel_variants.py
    dense; PERF.md §6). The narrower takes over where its rounds cost at
    least a tenth less: a ragged last round at a few rounds (the text
    tower's M = 7,777), or tiles too few for every SM (a small M). One
    block an SM, or one a tile where there are fewer."""
    wide, narrow = TILE_WIDTHS
    cost = {w: -(-_tiles(m, n, w) // sms) * w for w in TILE_WIDTHS}
    keep, of = NARROW_GAIN
    width = narrow if of * cost[narrow] <= keep * cost[wide] else wide
    return width, min(_tiles(m, n, width), sms)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def dense_plain(x2: torch.Tensor, w: torch.Tensor,
                b: Optional[torch.Tensor]) -> torch.Tensor:
    """The plain version: the f32 product of the rounded operands (a
    product of two bf16 values is exact in f32) plus the f32 bias, rounded
    once to x2's dtype."""
    y = torch.mm(x2.float(), w.float().t())
    if b is not None:
        y = y + b.float()
    return y.to(x2.dtype)


def library_dense(x2: torch.Tensor, w: torch.Tensor,
                  b: Optional[torch.Tensor]) -> torch.Tensor:
    """The library GEMM of a product D1 does not take: its f32 accumulator
    written (`out_dtype`), the bias added there, rounded once."""
    if b is None:
        y = torch.mm(x2, w.t(), out_dtype=torch.float32)
    else:
        y = torch.addmm(b.float(), x2, w.t(), out_dtype=torch.float32)
    return y.to(x2.dtype)


def _tma_ready(t: torch.Tensor) -> torch.Tensor:
    """t contiguous from a 16-byte-aligned base (a view may start
    anywhere), as TMA copies it."""
    t = t.contiguous()
    return t.clone() if t.data_ptr() % 16 else t


def launch_dense(x2: torch.Tensor, w: torch.Tensor,
                 b: Optional[torch.Tensor]) -> torch.Tensor:
    """The CUDA implementation of `eventclip::dense_bf16`: D1 where
    `d1_takes`, else `library_dense`."""
    M, K = x2.shape
    N = w.shape[0]
    if not d1_takes(x2.dtype, N, K):
        return library_dense(x2, w, b)
    x2, w = _tma_ready(x2), _tma_ready(w)
    if b is not None:
        b = b.float().contiguous()
    out = torch.empty((M, N), dtype=x2.dtype, device=x2.device)
    if M == 0:
        return out
    width, blocks = dense_plan(M, N, _sm_count(out.device.index))
    lib = kernels.library("dense")
    with _on_device(out):
        rc = lib.dense_bf16(x2.data_ptr(), w.data_ptr(),
                            None if b is None else b.data_ptr(),
                            out.data_ptr(), M, N, K, width, blocks,
                            _stream(out))
    kernels.check(lib, rc, "dense_bf16")
    kernels.LAUNCHES["dense"] += 1
    return out


def _check(x2: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor]):
    if x2.dim() != 2 or w.dim() != 2 or x2.shape[1] != w.shape[1]:
        raise ValueError(f"dense_bf16 takes x2 [M, K] and w [N, K], got "
                         f"{tuple(x2.shape)} and {tuple(w.shape)}")
    if x2.dtype == torch.float32 or w.dtype != x2.dtype:
        raise ValueError(f"dense_bf16 takes x2 and w in one low-precision "
                         f"dtype, got {x2.dtype} and {w.dtype}")
    if b is not None and (b.shape != (w.shape[0],)
                          or b.dtype != torch.float32):
        raise ValueError(f"the bias must be float32 [{w.shape[0]}], got "
                         f"{b.dtype} {tuple(b.shape)}")


def dense_bf16(x2: torch.Tensor, w: torch.Tensor,
               b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x2 [M, K] @ w [N, K].T (+ f32 b [N]), accumulated in f32, rounded
    once to x2's dtype, through `eventclip::dense_bf16`."""
    _check(x2, w, b)
    return torch.ops.eventclip.dense_bf16(x2, w, b)
