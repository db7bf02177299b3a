"""S1, EVA02's SwiGLU glue (`eventclip::swiglu_ln`, ops/swiglu.py,
csrc/swiglu.cu): SiLU(gate) * value rounded once, `ffn_ln` over the H real
columns, the pad columns [H, Hs) 0.

On the CPU the op is `swiglu_plain`, held bit for bit to the inline code
models/clip/eva.py held before the op, at the debug towers' widths (170
stored as 176) and EVA02-L/14's (2730 stored as 2736). Cases named
`*_on_card` need a CUDA device and skip elsewhere:

    python -m pytest --noconftest tests/test_torch_swiglu.py -k on_card

There the kernel is held to `swiglu_plain` run on the same card within one
bf16 ulp (rtol 2^-7; atol 1e-3 for outputs near 0, where the two f32 sums
of the statistics, taken in different orders, differ in their last
bits), with the pad columns exactly 0."""

import pytest
import torch
import torch.nn.functional as F
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.library import opcheck

from eventclip_tpu_torch import kernels
from eventclip_tpu_torch.models.clip import eva
from eventclip_tpu_torch.models.clip.config import clip_arch_config
from eventclip_tpu_torch.models.clip.model import layer_norm
from eventclip_tpu_torch.ops.swiglu import swiglu_ln, swiglu_plain

EPS = 1e-6
# (H, Hs): the debug towers' hidden, EVA02-L/14's
WIDTHS = sorted({(v.mlp_hidden, v.mlp_stored) for v in (
    clip_arch_config(a).vision for a in (
        "EVA02-T/8@48", "EVA02-T/8@32", "EVA02-CLIP-L-14-336"))})


def former(h12, ffn_ln):
    """The glue as models/clip/eva.py wrote it inline before the op."""
    Hs = h12.shape[-1] // 2
    H = ffn_ln.normalized_shape[0]
    h = (F.silu(h12[..., :H].float()) * h12[..., Hs:Hs + H].float()
         ).to(h12.dtype)
    return F.pad(layer_norm(h, ffn_ln), (0, Hs - H))


def ffn_ln(H, device=None, seed=1):
    gen = torch.Generator().manual_seed(seed)
    ln = torch.nn.LayerNorm(H, eps=EPS)
    with torch.no_grad():
        ln.weight.copy_(1 + 0.2 * torch.randn(H, generator=gen))
        ln.bias.copy_(0.1 * torch.randn(H, generator=gen))
    return ln.to(device)


def inputs(lead, Hs, dtype=torch.float32, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return (2 * torch.randn((*lead, 2 * Hs), generator=gen)).to(dtype)


def test_widths():
    assert WIDTHS == [(170, 176), (2730, 2736)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,Hs", WIDTHS)
def test_cpu_route_is_the_former_inline_code(H, Hs, dtype):
    ln = ffn_ln(H)
    h12 = inputs((3, 5), Hs, dtype)
    h12[..., H:Hs] = 7.0  # the pad columns hold anything
    h12[..., Hs + H:] = -3.0
    with torch.no_grad():
        want = former(h12, ln)
        for got in (eva.swiglu(h12, ln), swiglu_plain(h12, ln.weight,
                                                      ln.bias, EPS),
                    swiglu_ln(h12, ln.weight, ln.bias, EPS)):
            assert got.dtype == dtype and got.shape == (3, 5, Hs)
            assert torch.equal(got, want)
    assert not want[..., H:].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_op_passes_opcheck(dtype):
    H, Hs = 170, 176
    ln = ffn_ln(H)
    args = (inputs((2, 3), Hs, dtype), ln.weight.detach(),
            ln.bias.detach(), EPS)
    res = opcheck(torch.ops.eventclip.swiglu_ln.default, args)
    assert set(res.values()) == {"SUCCESS"}, res


def test_fake_gives_the_stored_width():
    with FakeTensorMode():
        h12 = torch.empty((4, 577, 2 * 2736), dtype=torch.bfloat16)
        w, b = torch.empty(2730), torch.empty(2730)
        out = torch.ops.eventclip.swiglu_ln(h12, w, b, EPS)
    assert out.shape == (4, 577, 2736) and out.dtype == torch.bfloat16


@pytest.mark.parametrize("case,exc,match", [
    ("odd last dim", ValueError, "2 Hs"),
    ("Hs < H", ValueError, "H <= Hs"),
    ("2-D weight", ValueError, "H <= Hs"),
    ("bias shape", ValueError, "bias"),
    ("bf16 weight", ValueError, "weight"),
    ("f64 bias", ValueError, "bias"),
    ("f16 h12", TypeError, "bf16 or f32"),
])
def test_wrapper_refuses_bad_arguments(case, exc, match):
    H, Hs = 170, 176
    h12 = inputs((2,), Hs)
    w, b = torch.ones(H), torch.zeros(H)
    args = {"odd last dim": (h12[..., :-1], w, b),
            "Hs < H": (inputs((2,), 168), w, b),
            "2-D weight": (h12, w[None], b),
            "bias shape": (h12, w, b[:-1]),
            "bf16 weight": (h12, w.bfloat16(), b),
            "f64 bias": (h12, w, b.double()),
            "f16 h12": (h12.half(), w, b)}[case]
    with pytest.raises(exc, match=match):
        swiglu_ln(*args, EPS)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel runs on the card only)")
    return torch.device("cuda")


def hold(got, want, H):
    torch.testing.assert_close(got.float(), want.float(), rtol=2 ** -7,
                               atol=1e-3)
    assert not got[..., H:].any()


# (leading dims, H, Hs): a request's 320 views at EVA02-L/14, the debug
# widths, a ragged M, M = 0, a pad of more than one vector, no pad, and
# rows that take a block more than 48 KB of shared memory
CARD = [((320, 577), 2730, 2736), ((4, 37), 170, 176), ((3, 37), 2730, 2736),
        ((0, 577), 2730, 2736), ((2, 5), 37, 48), ((9,), 1024, 1024),
        ((7,), 5000, 5008), ((5,), 10000, 10000)]


@pytest.mark.parametrize("lead,H,Hs", CARD)
def test_kernel_equals_the_plain_version_on_card(cuda, lead, H, Hs):
    gen = torch.Generator(device=cuda).manual_seed(H)
    h12 = (2 * torch.randn((*lead, 2 * Hs), generator=gen, device=cuda)
           ).bfloat16()
    ln = ffn_ln(H, cuda)
    w, b = ln.weight.detach(), ln.bias.detach()
    want = swiglu_plain(h12, w, b, EPS)
    kernels.reset_launches()
    got = swiglu_ln(h12, w, b, EPS)
    torch.cuda.synchronize()
    M = h12.numel() // (2 * Hs)
    assert dict(kernels.LAUNCHES) == ({"swiglu_ln": 1} if M else {})
    assert got.shape == (*lead, Hs) and got.dtype == torch.bfloat16
    hold(got, want, H)


def test_pad_columns_never_enter_the_kernel_on_card(cuda):
    H, Hs = 2730, 2736
    gen = torch.Generator(device=cuda).manual_seed(5)
    h12 = (2 * torch.randn((6, 37, 2 * Hs), generator=gen, device=cuda)
           ).bfloat16()
    ln = ffn_ln(H, cuda)
    w, b = ln.weight.detach(), ln.bias.detach()
    want = swiglu_plain(h12, w, b, EPS)
    junk = h12.clone()
    junk[..., H:Hs] = 1e4
    junk[..., Hs + H:] = -1e4
    got = swiglu_ln(junk, w, b, EPS)
    hold(got, want, H)
    assert torch.equal(got, swiglu_ln(h12, w, b, EPS))


def test_kernel_refuses_what_it_does_not_take_on_card(cuda):
    H, Hs = 170, 176
    ln = ffn_ln(H, cuda)
    w, b = ln.weight.detach(), ln.bias.detach()
    h12 = torch.zeros((4, 2 * Hs), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="bf16"):
        swiglu_ln(h12.float(), w, b, EPS)
    with pytest.raises(ValueError, match="multiple of 8"):
        swiglu_ln(torch.zeros((4, 2 * 172), device=cuda,
                              dtype=torch.bfloat16), w, b, EPS)
    with pytest.raises(ValueError, match="contiguous"):
        swiglu_ln(torch.zeros((2 * Hs, 4), device=cuda,
                              dtype=torch.bfloat16).t(), w, b, EPS)
    flat = torch.zeros(4 * 2 * Hs + 1, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte"):
        swiglu_ln(flat[1:].view(4, 2 * Hs), w, b, EPS)
    with pytest.raises(ValueError, match="weight"):
        swiglu_ln(h12, w.cpu(), b, EPS)
