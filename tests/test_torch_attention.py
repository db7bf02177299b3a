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
