"""The kernels as `torch.library` custom ops (ops/custom_ops.py).

`torch.library.opcheck` runs each op's schema, autograd registration, fake
implementation and AOT-dispatch tests on the CPU (the plain versions),
with and without the mask, in f32 and bf16; the CUDA implementations get
the same checks in tests/test_torch_card.py. Each attention op's output
and its `torch.autograd.grad` (K3, the registered autograd formula) are
held to the JAX package's Pallas kernels run in interpret mode through
`jax.vjp`, with tests/test_torch_attention*.py's tolerances: f32 atol
1e-5, bf16 atol 2e-2. `torch.export` of a one-block tower keeps the
`eventclip::` nodes, also through `run_decompositions` to core ATen and a
save / load round trip, with equal output (f32, atol 1e-6).
"""

import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.library import opcheck
from torch.utils._python_dispatch import TorchDispatchMode

from eventclip_tpu.ops.attention import fused_qkv_attention as ref_fused
from eventclip_tpu.ops.attention import multi_head_attention as ref_mha
from eventclip_tpu_torch import kernels
from eventclip_tpu_torch.models.clip.model import Block, causal_mask
from eventclip_tpu_torch.ops import attention, rasterize

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
OPS = torch.ops.eventclip


def _mask(S):
    return np.triu(np.full((S, S), -np.inf, np.float32), 1)


def _close(got, want, dtype):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(jnp.asarray(want, jnp.float32)),
                               atol=TOL[dtype], rtol=0)


def _opcheck(op, args):
    """Every opcheck test passes (opcheck raises on a failure)."""
    res = opcheck(op, args)
    assert set(res.values()) == {"SUCCESS"}, res


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mask", ["none", "causal", "learned"])
def test_opcheck_attention_ops(dtype, mask):
    gen = torch.Generator().manual_seed(len(mask))
    dt, S = TDT[dtype], 17
    m = None if mask == "none" else causal_mask(S)
    if mask == "learned":  # a mask that takes a gradient (the cotangent)
        m = (0.1 * torch.randn(S, S, generator=gen)).requires_grad_()
    qkv = torch.randn(2, S, 3 * 64, generator=gen).to(dt).requires_grad_()
    _opcheck(OPS.qkv_attention.default, (qkv, 2, m))
    q, k, v = (torch.randn(2, 2, S, 32, generator=gen).to(dt)
               .requires_grad_() for _ in range(3))
    _opcheck(OPS.attention.default, (q, k, v, m))
    md = None if m is None else m.detach()
    g = torch.randn(2, S, 64, generator=gen).to(dt)
    _opcheck(OPS.qkv_attention_bwd.default, (qkv.detach(), g, 2, md))
    _opcheck(OPS.attention_bwd.default,
             (q.detach(), k.detach(), v.detach(), torch.randn_like(q), md))


@pytest.mark.parametrize("ch,dtype", [(3, torch.int16), (4, torch.float32)])
def test_opcheck_event_histogram(ch, dtype):
    gen = torch.Generator().manual_seed(ch)
    w = torch.stack([torch.randint(-2, 26, (3, 200), generator=gen),
                     torch.randint(-2, 22, (3, 200), generator=gen)]
                    + [torch.randint(0, 5, (3, 200), generator=gen)]
                    * (ch - 3)
                    + [torch.randint(-1, 2, (3, 200), generator=gen)], -1)
    w = w.to(dtype)
    _opcheck(OPS.event_histogram.default, (w, 20, 24))
    assert torch.equal(rasterize.histograms(w, 20, 24),
                       rasterize.histograms_plain(w, 20, 24))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("dh", [16, 32, 64])
def test_qkv_attention_op_and_grad_match_pallas(dh, masked, dtype):
    heads, B, S = 2, 2, 17
    rng = np.random.default_rng(dh + masked)
    qkv = rng.normal(size=(B, S, 3 * heads * dh)).astype(np.float32)
    g = rng.normal(size=(B, S, heads * dh)).astype(np.float32)
    mask = _mask(S) if masked else None
    jm = None if mask is None else jnp.asarray(mask)
    out, vjp = jax.vjp(lambda x: ref_fused(x, heads, jm, use_pallas=True),
                       jnp.asarray(qkv).astype(JDT[dtype]))
    (want,) = vjp(jnp.asarray(g).astype(JDT[dtype]))
    tq = torch.from_numpy(qkv).to(TDT[dtype]).requires_grad_()
    tm = None if mask is None else torch.from_numpy(mask)
    got = OPS.qkv_attention(tq, heads, tm)
    (dq,) = torch.autograd.grad(got, tq, torch.from_numpy(g).to(TDT[dtype]))
    assert dq.dtype == tq.dtype and dq.shape == tq.shape
    _close(got, out, dtype)
    _close(dq, want, dtype)


def test_mask_cotangent_through_the_registered_formula():
    heads, dh, S = 2, 32, 17
    rng = np.random.default_rng(5)
    qkv = rng.normal(size=(2, S, 3 * heads * dh)).astype(np.float32)
    g = rng.normal(size=(2, S, heads * dh)).astype(np.float32)
    mask = (0.1 * rng.normal(size=(S, S))).astype(np.float32)
    _, vjp = jax.vjp(lambda x, m: ref_fused(x, heads, m, use_pallas=True),
                     jnp.asarray(qkv), jnp.asarray(mask))
    want_dqkv, want_dmask = vjp(jnp.asarray(g))
    tq = torch.from_numpy(qkv).requires_grad_()
    tm = torch.from_numpy(mask).requires_grad_()
    dq, dm = torch.autograd.grad(OPS.qkv_attention(tq, heads, tm), (tq, tm),
                                 torch.from_numpy(g))
    _close(dq, want_dqkv, "float32")
    np.testing.assert_allclose(dm.numpy(), np.asarray(want_dmask), atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("masked", [False, True])
def test_bhsd_attention_op_and_grad_match_pallas(masked, dtype):
    B, H, S, dh = 2, 3, 33, 32
    rng = np.random.default_rng(11 + masked)
    q, k, v, g = (rng.normal(size=(B, H, S, dh)).astype(np.float32)
                  for _ in range(4))
    mask = _mask(S) if masked else None
    jm = None if mask is None else jnp.asarray(mask)
    jdt = JDT[dtype]
    out, vjp = jax.vjp(
        lambda a, b, c: ref_mha(a, b, c, jm, use_pallas=True),
        *(jnp.asarray(x).astype(jdt) for x in (q, k, v)))
    want = vjp(jnp.asarray(g).astype(jdt))
    tq, tk, tv = (torch.from_numpy(x).to(TDT[dtype]).requires_grad_()
                  for x in (q, k, v))
    tm = None if mask is None else torch.from_numpy(mask)
    got = OPS.attention(tq, tk, tv, tm)
    grads = torch.autograd.grad(got, (tq, tk, tv),
                                torch.from_numpy(g).to(TDT[dtype]))
    _close(got, out, dtype)
    for a, b in zip(grads, want):
        _close(a, b, dtype)


def test_wrappers_route_through_the_ops():
    """The public wrappers launch the registered ops (their CPU
    implementations here count no launch) and the attention classes of
    earlier versions are gone: one route for every path."""
    assert not hasattr(attention, "_QKVAttention")
    assert not hasattr(attention, "_Attention")
    seen = []

    class Spy(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            seen.append(str(func))
            return func(*args, **(kwargs or {}))

    kernels.reset_launches()
    qkv = torch.randn(1, 5, 3 * 32, requires_grad=True)
    w = torch.zeros(1, 4, 3, dtype=torch.int16)
    with Spy():
        attention.fused_qkv_attention(qkv, 2).sum().backward()
        attention.multi_head_attention(*torch.randn(3, 1, 2, 5, 16))
        rasterize.histograms(w, 4, 4)
    for name in ("qkv_attention", "qkv_attention_bwd", "attention",
                 "event_histogram"):
        assert f"eventclip.{name}.default" in seen, (name, seen)
    assert sum(kernels.LAUNCHES.values()) == 0


class _OneBlock(torch.nn.Module):
    """A one-block text tower slice: the causal block over embeddings."""

    def __init__(self):
        super().__init__()
        gen = torch.Generator().manual_seed(0)
        self.block = Block(64, 2)
        with torch.no_grad():
            for p in self.block.parameters():
                p.copy_(0.1 * torch.randn(p.shape, generator=gen))

    def forward(self, x, windows):
        h = self.block(x, causal_mask(x.shape[1]))
        return h, rasterize.histograms(windows, 12, 16)


def _kept(ep):
    return {str(n.target) for n in ep.graph.nodes
            if str(n.target).startswith("eventclip.")}


def test_export_keeps_the_ops_through_decomposition():
    """A traced graph holds each kernel as one op node, which no
    decomposition to core ATen and no save / load replaces by its plain
    version: on the card the node launches the kernel."""
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(3, 9, 64, generator=gen)
    w = torch.stack([torch.randint(0, 16, (2, 300), generator=gen),
                     torch.randint(0, 12, (2, 300), generator=gen),
                     torch.randint(-1, 2, (2, 300), generator=gen)],
                    -1).to(torch.int16)
    model = _OneBlock()
    with torch.no_grad():
        ep = torch.export.export(model, (x, w), strict=False)
        want = model(x, w)
    core = ep.run_decompositions()
    buf = io.BytesIO()
    torch.export.save(core, buf)
    loaded = torch.export.load(io.BytesIO(buf.getvalue()))
    for prog in (ep, core, loaded):
        assert _kept(prog) == {"eventclip.qkv_attention.default",
                               "eventclip.event_histogram.default"}
    for fn in (ep.module(), core.module(), loaded.module()):
        got = fn(x, w)
        torch.testing.assert_close(got[0], want[0], atol=1e-6, rtol=0)
        assert torch.equal(got[1], want[1])
