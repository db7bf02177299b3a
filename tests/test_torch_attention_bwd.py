"""The port's attention gradients vs the JAX package's.

`jax.vjp` through `fused_qkv_attention` / `multi_head_attention` runs the
Pallas backward kernel K3 (`_bwd_kernel`) in interpret mode on the CPU; the
port's autograd runs its plain backward (what a CPU tensor takes), the same
arithmetic as the CUDA kernel csrc/attention_bwd.cu, which
tests/test_torch_card.py and chip_smoke.py hold to it on the card.

Tolerances: f32 atol 1e-5. bf16 atol 2e-2: both sides round ds * scale and
p to bf16 and the outputs to bf16, but sum in different orders, so a value
near a rounding boundary can land one bf16 ulp apart (2^-7 relative), and
a flip of one rounded ds moves its row's dq by that ulp times k.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eventclip_tpu.ops.attention import fused_qkv_attention as ref_fused
from eventclip_tpu.ops.attention import multi_head_attention as ref_mha
from eventclip_tpu_torch.ops.attention import (
    attention_bwd,
    attention_bwd_plain,
    fused_qkv_attention,
    multi_head_attention,
    qkv_attention_bwd,
    qkv_attention_bwd_plain,
)

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _mask(S):
    return np.triu(np.full((S, S), -np.inf, np.float32), 1)


def _close(got, want, dtype):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=TOL[dtype], rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("S", [17, 77])
@pytest.mark.parametrize("dh", [16, 32, 64])
def test_fused_qkv_grad_matches_pallas_kernel(dh, S, masked, dtype):
    heads, B = 2, 2
    rng = np.random.default_rng(S * dh + masked)
    qkv = rng.normal(size=(B, S, 3 * heads * dh)).astype(np.float32)
    g = rng.normal(size=(B, S, heads * dh)).astype(np.float32)
    mask = _mask(S) if masked else None
    jm = None if mask is None else jnp.asarray(mask)
    jq = jnp.asarray(qkv).astype(JDT[dtype])
    out, vjp = jax.vjp(lambda x: ref_fused(x, heads, jm, use_pallas=True), jq)
    (want,) = vjp(jnp.asarray(g).astype(JDT[dtype]))

    tq = torch.from_numpy(qkv).to(TDT[dtype]).requires_grad_()
    tm = None if mask is None else torch.from_numpy(mask)
    got_out = fused_qkv_attention(tq, heads, tm)
    got_out.backward(torch.from_numpy(g).to(TDT[dtype]))
    assert tq.grad.dtype == tq.dtype and tq.grad.shape == tq.shape
    _close(got_out, out, dtype)
    _close(tq.grad, want, dtype)


@pytest.mark.parametrize("masked", [False, True])
def test_fused_qkv_grad_matches_pallas_kernel_f32_at_577(masked):
    # ViT-L/14@336's sequence in f32, which the CUDA backward once refused
    heads, dh, S, B = 2, 16, 577, 1
    rng = np.random.default_rng(S + masked)
    qkv = rng.normal(size=(B, S, 3 * heads * dh)).astype(np.float32)
    g = rng.normal(size=(B, S, heads * dh)).astype(np.float32)
    mask = _mask(S) if masked else None
    jm = None if mask is None else jnp.asarray(mask)
    out, vjp = jax.vjp(lambda x: ref_fused(x, heads, jm, use_pallas=True),
                       jnp.asarray(qkv))
    (want,) = vjp(jnp.asarray(g))
    tq = torch.from_numpy(qkv).requires_grad_()
    tm = None if mask is None else torch.from_numpy(mask)
    got_out = fused_qkv_attention(tq, heads, tm)
    got_out.backward(torch.from_numpy(g))
    _close(got_out, out, "float32")
    _close(tq.grad, want, "float32")


@pytest.mark.parametrize("masked", [False, True])
def test_mask_cotangent_matches_jax(masked):
    heads, dh, S = 2, 32, 17
    rng = np.random.default_rng(3)
    qkv = rng.normal(size=(2, S, 3 * heads * dh)).astype(np.float32)
    g = rng.normal(size=(2, S, heads * dh)).astype(np.float32)
    mask = _mask(S) if masked else (
        0.1 * rng.normal(size=(S, S))).astype(np.float32)
    _, vjp = jax.vjp(lambda x, m: ref_fused(x, heads, m, use_pallas=True),
                     jnp.asarray(qkv), jnp.asarray(mask))
    want_dqkv, want_dmask = vjp(jnp.asarray(g))
    tq = torch.from_numpy(qkv).requires_grad_()
    tm = torch.from_numpy(mask).requires_grad_()
    fused_qkv_attention(tq, heads, tm).backward(torch.from_numpy(g))
    _close(tq.grad, want_dqkv, "float32")
    np.testing.assert_allclose(tm.grad.numpy(), np.asarray(want_dmask),
                               atol=1e-5, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("dh", [16, 64])
def test_bhsd_attention_matches_pallas_kernels(dh, masked, dtype):
    """K4's forward and its K3 backward in the [B, H, S, dh] layout."""
    B, H, S = 2, 3, 33
    rng = np.random.default_rng(dh + masked)
    q, k, v, g = (rng.normal(size=(B, H, S, dh)).astype(np.float32)
                  for _ in range(4))
    mask = _mask(S) if masked else None
    jm = None if mask is None else jnp.asarray(mask)
    jqkv = [jnp.asarray(t).astype(JDT[dtype]) for t in (q, k, v)]
    out, vjp = jax.vjp(lambda a, b, c: ref_mha(a, b, c, jm), *jqkv)
    wants = vjp(jnp.asarray(g).astype(JDT[dtype]))

    tqkv = [torch.from_numpy(t).to(TDT[dtype]).requires_grad_()
            for t in (q, k, v)]
    tm = None if mask is None else torch.from_numpy(mask)
    got = multi_head_attention(*tqkv, tm)
    got.backward(torch.from_numpy(g).to(TDT[dtype]))
    _close(got, out, dtype)
    for t, want in zip(tqkv, wants):
        _close(t.grad, want, dtype)


def test_causal_first_row_has_zero_key_gradient_beyond_itself():
    """Row 0 of the causal mask attends only to key 0: p = 0 and ds = 0
    for every later key, with no inf - inf anywhere."""
    rng = np.random.default_rng(1)
    S, heads, dh = 9, 1, 16
    qkv = torch.from_numpy(rng.normal(size=(1, S, 3 * dh)).astype(np.float32))
    g = torch.zeros(1, S, dh)
    g[0, 0] = 1.0  # only row 0's output carries gradient
    dqkv = qkv_attention_bwd(qkv, g, heads, torch.from_numpy(_mask(S)))
    assert torch.isfinite(dqkv).all()
    assert (dqkv[0, 1:] == 0).all()  # keys / values past 0 get nothing
    torch.testing.assert_close(dqkv[0, 0, 2 * dh:], g[0, 0], rtol=0, atol=0)


def test_fused_and_bhsd_backward_agree():
    """One backward, two layouts: the fused gradient is the [B, H, S, dh]
    one with its heads merged back into columns."""
    rng = np.random.default_rng(2)
    B, S, heads, dh = 2, 17, 2, 32
    qkv = torch.from_numpy(rng.normal(size=(B, S, 3 * heads * dh))
                           .astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(B, S, heads * dh))
                         .astype(np.float32))
    q, k, v = (t.reshape(B, S, heads, dh).transpose(1, 2).contiguous()
               for t in qkv.split(heads * dh, -1))
    gh = g.reshape(B, S, heads, dh).transpose(1, 2).contiguous()
    got = qkv_attention_bwd(qkv, g, heads)
    parts = attention_bwd(q, k, v, gh)
    want = torch.cat([t.transpose(1, 2).reshape(B, S, -1) for t in parts], -1)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    torch.testing.assert_close(got, qkv_attention_bwd_plain(qkv, g, heads),
                               rtol=0, atol=0)
    torch.testing.assert_close(parts[0], attention_bwd_plain(q, k, v, gh)[0],
                               rtol=0, atol=0)


def test_backward_wrappers_check_their_input():
    qkv = torch.zeros(1, 5, 3 * 64)
    with pytest.raises(ValueError):  # wrong g shape
        qkv_attention_bwd(qkv, torch.zeros(1, 5, 32), 1)
    with pytest.raises(ValueError):  # g dtype differs from qkv's
        qkv_attention_bwd(qkv, torch.zeros(1, 5, 64, dtype=torch.bfloat16), 1)
    q = torch.zeros(1, 2, 5, 16)
    with pytest.raises(ValueError):  # k of another shape
        attention_bwd(q, torch.zeros(1, 2, 6, 16), q, q)
    with pytest.raises(TypeError):
        multi_head_attention(q.half(), q.half(), q.half())


def _online_f32_backward(q, k, v, g, mask):
    """csrc/attention_bwd.cu's f32 route for one [S, dh] head in numpy f32,
    in its rounding order: online m, l = sum exp(s - m) and t = sum dp *
    exp(s - m) over 64-key tiles, each row's keys split over 16 lanes
    (keys j and j + 16 in one lane), rescaled as m grows; then delta = t / l,
    p = exp(s - m) * rcp(l) and ds = fl(fl(p * fl(dp - delta)) * scale)."""
    f32 = np.float32
    S, dh = q.shape
    scale = f32(dh ** -0.5)
    s_all = ((q @ k.T).astype(f32) * scale).astype(f32)
    if mask is not None:
        s_all = (s_all + mask).astype(f32)
    dp_all = (g @ v.T).astype(f32)
    m = np.full(S, -np.inf, f32)
    l, t = np.zeros((S, 16), f32), np.zeros((S, 16), f32)
    for j0 in range(0, S, 64):
        pad = ((0, 0), (0, 64 - min(64, S - j0)))
        sc = np.pad(s_all[:, j0:j0 + 64], pad, constant_values=-np.inf)
        dp = np.pad(dp_all[:, j0:j0 + 64], pad)
        mn = np.maximum(m, sc.max(1))
        base = np.where(mn == -np.inf, 0, mn).astype(f32)
        e = np.exp(sc - base[:, None]).astype(f32).reshape(S, 4, 16)
        dp = dp.reshape(S, 4, 16)
        esum, tsum = np.zeros((S, 16), f32), np.zeros((S, 16), f32)
        for u in range(4):
            esum = (esum + e[:, u]).astype(f32)
            tsum = (tsum + dp[:, u] * e[:, u]).astype(f32)
        fac = np.exp(m - base).astype(f32)[:, None]
        l, t, m = (l * fac + esum).astype(f32), (t * fac + tsum).astype(f32), mn
    lsum, tsum = l.sum(1, dtype=f32), t.sum(1, dtype=f32)
    delta, rl = (tsum / lsum).astype(f32), (f32(1) / lsum).astype(f32)
    p = (np.exp(s_all - m[:, None]).astype(f32) * rl[:, None]).astype(f32)
    ds = ((p * (dp_all - delta[:, None])).astype(f32) * scale).astype(f32)
    return ds @ k, ds.T @ q, p.T @ g


@pytest.mark.parametrize("S,masked", [(77, True), (257, False), (577, False)])
def test_f32_online_statistics_stay_within_the_card_limits(S, masked):
    # the f32 kernels' online softmax statistics re-round l and t at every
    # 64-key tile; their dq, dk, dv stay within chip_smoke's f32 limits of
    # the plain version (max-abs 1e-5, norm-relative 1e-6)
    from chip_smoke import ATOL, REL

    rng = np.random.default_rng(S)
    q, k, v, g = (rng.standard_normal((2, 2, S, 64)).astype(np.float32)
                  for _ in range(4))
    mask = _mask(S) if masked else None
    want = attention_bwd_plain(*(torch.from_numpy(x) for x in (q, k, v, g)),
                               None if mask is None else torch.from_numpy(mask))
    for b in range(2):
        for h in range(2):
            got = _online_f32_backward(q[b, h], k[b, h], v[b, h], g[b, h],
                                       mask)
            for a, w in zip(got, want):
                w = w[b, h].numpy()
                assert np.abs(a - w).max() <= ATOL["float32"]
                assert (np.linalg.norm(a - w) / np.linalg.norm(w)
                        <= REL["float32"])
