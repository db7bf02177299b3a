"""The port's fused-qkv attention vs the JAX package's.

The plain version (what a CPU tensor runs) is held to the Pallas kernel
`_qkv_attention_forward`, which runs in interpret mode on the CPU, and to
the XLA reference path. f32: atol 1e-5. bf16: atol 2e-2 — the XLA path
scales q before the dot, so it rounds differently in bf16 from the kernel
(and the port), which scale after it.

The CUDA kernel itself is held to this plain version on the card by
tests/test_torch_card.py and chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eventclip_tpu.ops.attention import (
    _qkv_attention_forward,
    fused_qkv_attention as ref_fused_qkv_attention,
)
from eventclip_tpu_torch.models.clip.model import causal_mask
from eventclip_tpu_torch.ops.attention import (
    fused_qkv_attention,
    qkv_attention_plain,
)

TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _inputs(seed, B, S, heads, dh, masked):
    rng = np.random.default_rng(seed)
    qkv = rng.normal(size=(B, S, 3 * heads * dh)).astype(np.float32)
    mask = (np.triu(np.full((S, S), -np.inf, np.float32), 1)
            if masked else None)
    return qkv, mask


def _jax(dtype, qkv, mask):
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    return jnp.asarray(qkv).astype(jdt), (None if mask is None
                                          else jnp.asarray(mask))


def _torch(dtype, qkv, mask):
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    return torch.from_numpy(qkv).to(tdt), (None if mask is None
                                           else torch.from_numpy(mask))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("S", [17, 77])
@pytest.mark.parametrize("heads,dh", [(2, 32), (4, 64)])
def test_plain_matches_pallas_kernel(heads, dh, S, masked, dtype):
    qkv, mask = _inputs(S + dh, 2, S, heads, dh, masked)
    jq, jm = _jax(dtype, qkv, mask)
    want = np.asarray(_qkv_attention_forward(jq, jm, heads, dh ** -0.5)
                      .astype(jnp.float32))
    tq, tm = _torch(dtype, qkv, mask)
    got = fused_qkv_attention(tq, heads, tm)
    assert got.dtype == tq.dtype and got.shape == (2, S, heads * dh)
    np.testing.assert_allclose(got.float().numpy(), want, atol=TOL[dtype],
                               rtol=0)


@pytest.mark.parametrize("masked", [False, True])
def test_plain_matches_pallas_kernel_f32_at_577(masked):
    # ViT-L/14@336's sequence in f32, which the CUDA kernel once refused
    heads, dh, S = 2, 16, 577
    qkv, mask = _inputs(S + masked, 1, S, heads, dh, masked)
    jq, jm = _jax("float32", qkv, mask)
    want = np.asarray(_qkv_attention_forward(jq, jm, heads, dh ** -0.5))
    tq, tm = _torch("float32", qkv, mask)
    got = fused_qkv_attention(tq, heads, tm)
    assert got.shape == (1, S, heads * dh)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL["float32"], rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("masked", [False, True])
def test_plain_matches_xla_reference(masked, dtype):
    heads, dh, S = 4, 64, 77
    qkv, mask = _inputs(7, 3, S, heads, dh, masked)
    jq, jm = _jax(dtype, qkv, mask)
    want = np.asarray(ref_fused_qkv_attention(jq, heads, jm, use_pallas=False)
                      .astype(jnp.float32))
    tq, tm = _torch(dtype, qkv, mask)
    got = qkv_attention_plain(tq, heads, tm).float().numpy()
    np.testing.assert_allclose(got, want, atol=TOL[dtype], rtol=0)


def test_causal_first_row_attends_only_to_itself():
    """Row 0 of the causal mask has one finite score: its output is v_0
    exactly, with no inf - inf anywhere."""
    qkv, _ = _inputs(1, 1, 9, 2, 16, False)
    tq = torch.from_numpy(qkv)
    out = fused_qkv_attention(tq, 2, causal_mask(9))
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out[0, 0], tq[0, 0, 64:], rtol=0, atol=0)


def test_wrapper_checks_its_input():
    q = torch.zeros(1, 5, 3 * 64)
    with pytest.raises(ValueError):  # dh 64/3 is not a kernel head dim
        fused_qkv_attention(q, 3)
    with pytest.raises(TypeError):
        fused_qkv_attention(q.half(), 1)
    with pytest.raises(ValueError):
        fused_qkv_attention(q, 1, torch.zeros(4, 4))
    with pytest.raises(ValueError):
        fused_qkv_attention(torch.zeros(1, 3 * 64, 5).transpose(1, 2), 1)


@pytest.mark.parametrize("ptrs,strides,ok_bf16,ok_f32", [
    ((0, 2048), (257 * 3072, 64, 3072), True, True),  # fused ViT-L/14 qkv
    ((0, 32), (257 * 96, 16, 96), True, True),  # fused, dh 16
    ((0, 64), (77 * 2304, 64, 2304), True, True),  # fused text tower
    ((0,), (12 * 77 * 16, 77 * 16, 16), True, True),  # [B, H, S, dh], dh 16
    ((2,), (257 * 3072, 64, 3072), False, False),  # a view 2 bytes past 16
    ((4,), (257 * 3072, 64, 3072), False, False),  # a view 4 bytes past 16
    ((0,), (9 * 1538, 64, 1538), False, False),  # a row of 3076 / 6152 bytes
    ((0,), (9 * 3072, 4, 3072), False, True),  # a head of 8 / 16 bytes
    ((0,), (9 * 3074, 64, 3074), False, False),  # f32 rows 8 bytes past 16
])
def test_bf16_rows_must_be_16_byte_aligned(ptrs, strides, ok_bf16, ok_f32):
    # the rule the forward kernels' 16-byte copies need, in bf16 (tensor
    # cores) and in f32 (CUDA cores) alike
    from eventclip_tpu_torch.ops.attention import _check_rows_aligned

    for dtype, ok in ((torch.bfloat16, ok_bf16), (torch.float32, ok_f32)):
        if ok:
            _check_rows_aligned(dtype, [(ptrs, strides)])
        else:
            with pytest.raises(ValueError, match="16-byte aligned"):
                _check_rows_aligned(dtype, [((0,), (0, 0, 0)),
                                            (ptrs, strides)])


# -- the bf16 kernels' TMA tensor maps (ops/attention.py tma_map) ------------


def _layout_strides(layout, B, S, heads, dh):
    """(batch, head, row) element strides of one operand, as the launchers
    give them: the fused qkv [B, S, 3D], a tensor-parallel rank's [B, S,
    3D/2] of the same model (half the heads), and [B, H, S, dh]."""
    D = heads * dh
    if layout == "fused":
        return (S * 3 * D, dh, 3 * D)
    if layout == "tp slice":
        return (S * 3 * D // 2, dh, 3 * D // 2)
    return (heads * S * dh, S * dh, dh)


@pytest.mark.parametrize("dh", [16, 32, 64])
@pytest.mark.parametrize("layout", ["fused", "tp slice", "[B, H, S, dh]"])
def test_tma_map_geometry_of_each_layout(layout, dh):
    from eventclip_tpu_torch.ops.attention import tma_map

    B, S, heads = 3, 257, 16
    if layout == "tp slice":
        heads //= 2  # the rank's heads
    strides = _layout_strides(layout, B, S, 2 * heads if layout == "tp slice"
                              else heads, dh)
    m = tma_map(B, S, heads, dh, strides)
    # dims innermost first: a head's columns, its rows (S: TMA zero-fills
    # the ragged last box), the heads, the batch
    assert m.dims == (dh, S, heads, B)
    # byte strides of a row, a head and a batch, each a multiple of 16
    assert m.strides == (2 * strides[2], 2 * strides[1], 2 * strides[0])
    assert all(s % 16 == 0 for s in m.strides)
    # one copy: 64 rows of one head
    assert m.box == (dh, 64, 1, 1)
    # the swizzle of one row: the wgmma descriptors read it
    assert m.swizzle == {16: 32, 32: 64, 64: 128}[dh] == 2 * dh
    assert list(m.as_ctypes()) == [*m.dims, *m.strides, *m.box, m.swizzle]


@pytest.mark.parametrize("dh", [16, 32, 64])
def test_tma_map_of_the_output_and_gradient_layouts(dh):
    # the fused forward's [B, S, D] output and the backward's [B, S, D]
    # output gradient share one geometry; [B, H, S, dh] out is q's
    from eventclip_tpu_torch.ops.attention import tma_map

    B, S, heads = 2, 77, 12
    D = heads * dh
    m = tma_map(B, S, heads, dh, (S * D, dh, D))
    assert m.dims == (dh, S, heads, B)
    assert m.strides == (2 * D, 2 * dh, 2 * S * D)


@pytest.mark.parametrize("dh", [8, 48, 128])
def test_tma_map_refuses_an_unsupported_head_dim(dh):
    from eventclip_tpu_torch.ops.attention import tma_map

    with pytest.raises(ValueError, match="head dim"):
        tma_map(2, 17, 2, dh, (17 * 6 * dh, dh, 6 * dh))


@pytest.mark.parametrize("strides", [
    (9 * 1538, 64, 1538),  # a row of 3076 bytes
    (9 * 3072, 4, 3072),  # a head 8 bytes after the last
    (9 * 3072 + 1, 64, 3072),  # a batch 2 bytes past 16
])
def test_tma_map_refuses_strides_off_16_bytes(strides):
    from eventclip_tpu_torch.ops.attention import tma_map

    with pytest.raises(ValueError, match="16-byte"):
        tma_map(2, 9, 16, 64, strides)


@pytest.mark.parametrize("S", [1, 64, 65, 257])
def test_stats_map_covers_whole_boxes_of_every_head(S):
    from eventclip_tpu_torch.ops.attention import stats_map, stats_rows

    bh = 6
    sp = stats_rows(S)
    assert sp % 64 == 0 and sp - 64 < S <= sp
    m = stats_map(bh, S)
    # [3, bh, sp] f32: a box is one head's 64 rows of m, 1 / sum, delta
    assert m.dims == (sp, bh, 3, 1)
    assert m.strides == (4 * sp, 4 * bh * sp, 12 * bh * sp)
    assert m.box == (64, 1, 3, 1) and m.swizzle == 0


def _recording_library(monkeypatch, calls):
    """Launchers run against a stand-in library that records its
    arguments (there is no card here)."""
    import contextlib

    from eventclip_tpu_torch import kernels
    from eventclip_tpu_torch.ops import attention as A

    class Lib:
        def __getattr__(self, name):
            def record(*args):
                calls.append((name, args))
                return 0
            return record

    monkeypatch.setattr(kernels, "library", lambda name: Lib())
    monkeypatch.setattr(A, "_stream", lambda t: 0)
    monkeypatch.setattr(A, "_on_device", lambda t: contextlib.nullcontext())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_launchers_pass_the_tma_maps_to_the_bf16_kernels(monkeypatch, dtype):
    # the fused forward and backward hand the kernels tma_map's geometry of
    # q/k/v (and dq/dk/dv), of the output or output gradient and of the
    # statistics scratch; the f32 kernels get none
    from eventclip_tpu_torch.ops import attention as A

    calls = []
    _recording_library(monkeypatch, calls)
    B, S, heads, dh = 2, 65, 2, 32
    D = heads * dh
    qkv = torch.zeros((B, S, 3 * D), dtype=dtype)
    A.launch_qkv_attention(qkv, heads, None)
    A.launch_qkv_attention_bwd(qkv, torch.zeros((B, S, D), dtype=dtype),
                               heads, None)
    (fwd, fargs), (bwd, bargs) = calls
    assert (fwd, bwd) == ("attention_fwd", "attention_bwd")
    if dtype == torch.float32:
        assert fargs[-2:] == (None, None) and bargs[-3:] == (None,) * 3
        return
    qkv_map = A.tma_map(B, S, heads, dh, (S * 3 * D, dh, 3 * D))
    out_map = A.tma_map(B, S, heads, dh, (S * D, dh, D))
    assert [list(g) for g in fargs[-2:]] == [list(qkv_map.as_ctypes()),
                                            list(out_map.as_ctypes())]
    assert [list(g) for g in bargs[-3:]] == [
        list(qkv_map.as_ctypes()), list(out_map.as_ctypes()),
        list(A.stats_map(B * heads, S).as_ctypes())]
