"""Each CUDA kernel vs its plain PyTorch version, on the card.

These skip without a CUDA device. The file imports neither JAX nor the JAX
package, so it also runs on a machine without them:

    python -m pytest --noconftest tests/test_torch_card.py -q

Tolerances (chip_smoke.py's `ATOL` and `REL`): the histogram is exact,
also on adversarial windows, in row bands and under every plan;
attention forward and backward are held, output by output, to a max
|kernel - plain| (f32 1e-5, bf16 2e-2: the kernel and the plain version
sum in different orders, and bf16 rounds p, ds and the outputs, so a value
near a rounding boundary lands one bf16 ulp apart) and to a norm-relative
||kernel - plain|| / ||plain||, which in bf16 tells the TPU kernels'
rounding order from others that the max-abs limit lets through (checked
here on the CPU). The backward kernel is also held to give the same bits
on two runs (no atomics). bf16 runs on the wgmma kernels (TMA copies
through tensor maps): their cases cover every head dim, ragged 64-row
tiles and 16-key steps, the causal mask and both layouts, the pruned
serving shape (S = 129), each kernel's largest S whose operands stay
resident in shared memory and one row more (streamed through its ring),
and a tensor-parallel slice whose k and v blocks start at an odd head.
D1, the bf16 dense product (csrc/dense.cu), is held to the exact f64 sum
of its bf16 operands plus the f32 bias at every path's shapes (within one
bf16 ulp plus the f32 sums' own bound, and no more elements off the exact
rounding than the library route it replaced), counted 96 times a
32-recording ViT-L/14 request, and absent where K = 588 (the patch
embedding keeps the library GEMM).
The W8A8 int8 product (`torch._int_mm`, a library call, not a kernel of
this repository) is held bit-equal to the CPU route at ViT-L/14's widths,
among them `patch_embed`'s K = 588, which the card takes only padded.
"""

import pytest
import torch

from chip_smoke import ATOL, REL, other_rounding_orders, rel_errs
from eventclip_tpu_torch import kernels
from eventclip_tpu_torch.models.clip.model import causal_mask
from eventclip_tpu_torch.ops.attention import (
    attention_bwd,
    attention_bwd_plain,
    attention_plain,
    fused_qkv_attention,
    multi_head_attention,
    qkv_attention_bwd,
    qkv_attention_bwd_plain,
    qkv_attention_plain,
)
from eventclip_tpu_torch.ops.rasterize import histograms, histograms_plain
from eventclip_tpu_torch.utils.config import Params

SHAPES = [
    (torch.bfloat16, 257, 16, 64, False),  # ViT-L/14
    (torch.float32, 77, 12, 64, True),  # ViT-L/14 text tower
    (torch.float32, 17, 2, 32, False),  # ViT-T/8@32
    (torch.bfloat16, 17, 2, 32, False),
    (torch.float32, 77, 2, 16, True),  # ViT-T/8@32 text tower
]


class _ZSL14(Params):  # configs/zsclip/zsclip_ncaltech_params.py
    gpus = 1
    dataset = "n_caltech"
    data_root = "/nonexistent"
    quantize_args = dict(
        max_imgs=2, N=20000, split_method="event_count",
        convert_method="event_histogram", grayscale=True,
        count_non_zero=False, background_mask=True)
    model = "ZSCLIP"
    clip_dict = dict(arch="ViT-L/14", prompt="a point cloud image of a {}",
                     agg_func="mean")
    bf16 = True


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run on the card only)")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype,S,heads,dh,masked", [
    (torch.bfloat16, 257, 16, 64, False),  # ViT-L/14
    (torch.float32, 77, 12, 64, True),  # ViT-L/14 text tower
    (torch.float32, 17, 2, 32, False),  # ViT-T/8@32
    (torch.float32, 77, 2, 16, True),  # ViT-T/8@32 text tower
])
def test_attention_kernel_matches_plain_on_card(cuda, dtype, S, heads, dh,
                                                masked):
    gen = torch.Generator(device=cuda).manual_seed(0)
    qkv = torch.randn((4, S, 3 * heads * dh), generator=gen,
                      device=cuda).to(dtype)
    mask = causal_mask(S, device=cuda) if masked else None
    _assert_matches([fused_qkv_attention(qkv, heads, mask)],
                    [qkv_attention_plain(qkv, heads, mask)], dtype)


@pytest.mark.parametrize("H,W", [(180, 240), (100, 120), (480, 640)])
def test_histogram_kernel_matches_plain_on_card(cuda, H, W):
    gen = torch.Generator(device=cuda).manual_seed(H)
    wins = _windows(gen, 4, 5000, H, W, cuda)
    assert torch.equal(histograms(wins, H, W), histograms_plain(wins, H, W))


def _windows(gen, M, N, H, W, device):
    """Packed int16 [M, N, 3] windows with out-of-bounds and p == 0 rows."""
    return torch.stack([
        torch.randint(-20, W + 20, (M, N), generator=gen, device=device),
        torch.randint(-20, H + 20, (M, N), generator=gen, device=device),
        torch.randint(-1, 2, (M, N), generator=gen, device=device),
    ], -1).to(torch.int16).contiguous()


def _f32_layout(wins):
    """The same events as [M, N, 4] float32 x, y, t = 0, p."""
    return torch.cat([wins[..., :2], torch.zeros_like(wins[..., :1]),
                      wins[..., 2:]], -1).float().contiguous()


@pytest.mark.parametrize("case", ["one pixel", "only p == 0",
                                  "only out of bounds", "N not a multiple "
                                  "of the block", "M = 1"])
def test_histogram_kernel_exact_on_adversarial_windows(cuda, case):
    # 480x640 (a cluster of 16 CTAs in two bands) with windows that pile
    # every event on one bin, drop them all, or leave ragged ends
    H, W, N = 480, 640, 70000
    gen = torch.Generator(device=cuda).manual_seed(7)
    wins = _windows(gen, 3, N, H, W, cuda)
    if case == "one pixel":  # every event on one bin, both polarities
        wins[..., 0], wins[..., 1] = 5, 7
        wins[0, :, 2], wins[1, :, 2] = 1, -1
    elif case == "only p == 0":
        wins[..., 2] = 0
    elif case == "only out of bounds":
        wins[..., 0] = torch.where(wins[..., 0] % 2 == 0, -1, W)
    elif case == "N not a multiple of the block":
        wins = wins[:, :5001].contiguous()
    else:
        wins = wins[:1].contiguous()
    for w in (wins, _f32_layout(wins)):
        got = histograms(w, H, W)
        assert torch.equal(got, histograms_plain(wins, H, W))
    if case == "one pixel":
        assert got[0, 0, 7, 5] == N and got[1, 1, 7, 5] == N
    if case in ("only p == 0", "only out of bounds"):
        assert not got.any()


@pytest.mark.parametrize("H,W", [(480, 640), (720, 1280)])
@pytest.mark.parametrize("layout", ["packed", "f32"])
def test_histogram_kernel_exact_at_large_frames(cuda, H, W, layout):
    # N-ImageNet's 480x640 and a 720x1280 frame, which runs in row bands
    gen = torch.Generator(device=cuda).manual_seed(W)
    wins = _windows(gen, 5, 70000, H, W, cuda)
    w = wins if layout == "packed" else _f32_layout(wins)
    assert torch.equal(histograms(w, H, W), histograms_plain(wins, H, W))


@pytest.mark.parametrize("offset", [1, 2, 3])
def test_histogram_kernel_exact_on_misaligned_f32_windows(cuda, offset):
    # a contiguous [M, N, 4] f32 view 4 * offset bytes past a 16-byte
    # boundary: the kernel reads such events as scalars
    H, W = 180, 240
    gen = torch.Generator(device=cuda).manual_seed(offset)
    wins = _windows(gen, 3, 5001, H, W, cuda)
    f32 = _f32_layout(wins).flatten()
    flat = torch.empty(f32.numel() + offset, device=cuda)
    flat[offset:] = f32
    view = flat[offset:].view(3, 5001, 4)
    assert view.is_contiguous() and view.data_ptr() % 16 == 4 * offset
    assert torch.equal(histograms(view, H, W), histograms_plain(wins, H, W))
    torch.cuda.synchronize()


def test_histogram_kernel_exact_under_every_plan(cuda):
    # each cluster size and band count that covers a 180x240 plane
    from eventclip_tpu_torch.ops.rasterize import (HistogramPlan,
                                                     launch_histograms)

    H, W = 180, 240
    gen = torch.Generator(device=cuda).manual_seed(3)
    wins = _windows(gen, 6, 20000, H, W, cuda)
    want = histograms_plain(wins, H, W)
    for cluster in (1, 2, 4, 8, 16):
        for bands in (1, 2, 3):
            rows = -(-2 * H // (cluster * bands))
            if rows * W * 4 > 232448:
                continue
            plan = HistogramPlan(cluster, rows, bands)
            got = launch_histograms(wins, H, W, plan)
            assert torch.equal(got, want), plan


@pytest.mark.parametrize("S,heads,dh,masked", [
    (77, 12, 64, True),  # the ViT-L/14 text tower
    (77, 3, 32, True),
    (77, 2, 16, True),  # the ViT-T/8@32 text tower
    (17, 2, 32, False),
    (1, 2, 64, False),
    (65, 2, 64, False),
    (257, 4, 64, False),  # ViT-L/14's sequence
    (577, 4, 64, False),  # ViT-L/14@336's, refused before
    (577, 2, 16, True),
])
def test_f32_forward_kernel_matches_plain_on_card(cuda, S, heads, dh, masked):
    # the f32 forward on the CUDA cores, fused and [B, H, S, dh] layouts
    gen = torch.Generator(device=cuda).manual_seed(S * dh + masked)
    D = heads * dh
    qkv = torch.randn((2, S, 3 * D), generator=gen, device=cuda)
    mask = causal_mask(S, device=cuda) if masked else None
    _assert_matches([fused_qkv_attention(qkv, heads, mask)],
                    [qkv_attention_plain(qkv, heads, mask)], torch.float32)
    q, k, v = (t.reshape(2, S, heads, dh).transpose(1, 2).contiguous()
               for t in qkv.split(D, -1))
    _assert_matches([multi_head_attention(q, k, v, mask)],
                    [attention_plain(q, k, v, mask)], torch.float32)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("dh", [16, 32, 64])
@pytest.mark.parametrize("S", [17, 77, 257, 577, 2049])
def test_f32_backward_kernel_at_577_matches_plain_on_card(cuda, S, dh,
                                                          masked):
    # the f32 backward on the CUDA cores: below, at and past one 64-row
    # tile, ragged last tiles (77, 257, 577 and 2049 keep 13 or 1 key in
    # their last), S = 577 (once refused) and S = 2049 (no S-long buffer),
    # the causal mask, fused and [B, H, S, dh] layouts, two runs bit-equal
    gen = torch.Generator(device=cuda).manual_seed(S * dh + masked)
    heads = 2
    D = heads * dh
    qkv = torch.randn((2, S, 3 * D), generator=gen, device=cuda)
    g = torch.randn((2, S, D), generator=gen, device=cuda)
    mask = causal_mask(S, device=cuda) if masked else None
    got = qkv_attention_bwd(qkv, g, heads, mask)
    assert torch.equal(got, qkv_attention_bwd(qkv, g, heads, mask))
    _assert_matches(got.split(D, -1),
                    qkv_attention_bwd_plain(qkv, g, heads, mask).split(D, -1),
                    torch.float32)
    q, k, v, gh = (t.reshape(2, S, heads, dh).transpose(1, 2).contiguous()
                   for t in (*qkv.split(D, -1), g))
    got = attention_bwd(q, k, v, gh, mask)
    for a, b in zip(got, attention_bwd(q, k, v, gh, mask)):
        assert torch.equal(a, b)
    _assert_matches(got, attention_bwd_plain(q, k, v, gh, mask),
                    torch.float32)


def test_misaligned_f32_rows_raise_on_card(cuda):
    # the f32 forward copies 16 bytes too; the f32 backward takes any row
    B, S, D = 2, 9, 64
    flat = torch.randn(B * S * 3 * D + 1, device=cuda)
    qkv = flat[1:].view(B, S, 3 * D)
    kernels.reset_launches()
    with pytest.raises(ValueError, match="16-byte"):
        fused_qkv_attention(qkv, 1)
    assert dict(kernels.LAUNCHES) == {}
    g = torch.randn(B, S, D, device=cuda)
    _assert_matches(qkv_attention_bwd(qkv, g, 1).split(D, -1),
                    qkv_attention_bwd_plain(qkv, g, 1).split(D, -1),
                    torch.float32)


def test_dense_bf16_on_card_matches_cpu(cuda):
    # the CPU sums the exact bf16 products in f32 and adds the f32 bias once;
    # the card's f32-output GEMM must agree up to its summation order
    from eventclip_tpu_torch.models.clip.model import dense

    gen = torch.Generator().manual_seed(0)
    x = torch.randn((4, 16, 48), generator=gen).bfloat16()
    w = 0.02 * torch.randn((96, 48), generator=gen)
    b = torch.randn((96,), generator=gen)
    want = dense(x, w, b).float()
    got = dense(x.to(cuda), w.to(cuda), b.to(cuda)).float().cpu()
    ulp = torch.finfo(torch.bfloat16).eps * want.abs()
    assert ((got - want).abs() <= ulp).all()
    assert (got != want).float().mean() <= 1e-3


def test_cpu_tensors_take_the_plain_versions_and_count_no_launch():
    from eventclip_tpu_torch import kernels

    before = dict(kernels.LAUNCHES)
    qkv = torch.randn(2, 9, 3 * 32)
    torch.testing.assert_close(fused_qkv_attention(qkv, 1),
                               qkv_attention_plain(qkv, 1), rtol=0, atol=0)
    wins = torch.randint(-3, 12, (2, 50, 3), dtype=torch.int16)
    assert torch.equal(histograms(wins, 8, 10), histograms_plain(wins, 8, 10))
    assert dict(kernels.LAUNCHES) == before


def test_kernel_launches_are_counted_on_card(cuda):
    from eventclip_tpu_torch import kernels

    kernels.reset_launches()
    fused_qkv_attention(torch.randn(1, 5, 96, device=cuda), 1)
    histograms(torch.zeros((1, 4, 3), dtype=torch.int16, device=cuda), 8, 8)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES == {"qkv_attention": 1, "histogram": 1}


def _assert_matches(got, want, dtype):
    """Each kernel output within the max-abs and the norm-relative limit of
    its plain version."""
    name = str(dtype).split(".")[-1]
    for a, b in zip(got, want):
        torch.testing.assert_close(a.float(), b.float(), rtol=0,
                                   atol=ATOL[name])
    rel = rel_errs(got, want)
    assert max(rel) <= REL[name], rel


@pytest.mark.parametrize("S,dh", [(17, 16), (77, 64), (257, 16), (257, 64)])
def test_bf16_rel_limit_rejects_other_rounding_orders(S, dh):
    # runs on the CPU: the plain version with p divided after p . v, with
    # FlashAttention's rowsum(g * o), or with ds from the rounded p misses
    # the norm-relative limit that the kernels are held to
    gen = torch.Generator().manual_seed(S + dh)
    q, k, v, g = (torch.randn((2, 2, S, dh), generator=gen).bfloat16()
                  for _ in range(4))
    other = other_rounding_orders(q, k, v, g)
    assert len(other) == 3
    assert min(other.values()) > REL["bfloat16"], other


@pytest.mark.parametrize("dtype,S,heads,dh,masked", SHAPES)
def test_attention_bwd_kernel_matches_plain_on_card(cuda, dtype, S, heads,
                                                    dh, masked):
    gen = torch.Generator(device=cuda).manual_seed(1)
    D = heads * dh
    qkv = torch.randn((4, S, 3 * D), generator=gen, device=cuda).to(dtype)
    g = torch.randn((4, S, D), generator=gen, device=cuda).to(dtype)
    mask = causal_mask(S, device=cuda) if masked else None
    got = qkv_attention_bwd(qkv, g, heads, mask)
    assert torch.equal(got, qkv_attention_bwd(qkv, g, heads, mask))
    want = qkv_attention_bwd_plain(qkv, g, heads, mask)
    _assert_matches(got.split(D, -1), want.split(D, -1), dtype)


@pytest.mark.parametrize("dtype,S,heads,dh,masked", SHAPES[:3])
def test_bhsd_attention_kernels_match_plain_on_card(cuda, dtype, S, heads,
                                                    dh, masked):
    gen = torch.Generator(device=cuda).manual_seed(2)
    q, k, v, g = (torch.randn((3, heads, S, dh), generator=gen, device=cuda)
                  .to(dtype) for _ in range(4))
    mask = causal_mask(S, device=cuda) if masked else None
    _assert_matches([multi_head_attention(q, k, v, mask)],
                    [attention_plain(q, k, v, mask)], dtype)
    _assert_matches(attention_bwd(q, k, v, g, mask),
                    attention_bwd_plain(q, k, v, g, mask), dtype)


def test_backward_launches_are_counted_on_card(cuda):
    qkv = torch.randn(2, 9, 3 * 64, device=cuda, requires_grad=True)
    kernels.reset_launches()
    fused_qkv_attention(qkv, 2).sum().backward()
    q, k, v = (torch.randn(1, 2, 9, 32, device=cuda, requires_grad=True)
               for _ in range(3))
    multi_head_attention(q, k, v).sum().backward()
    torch.cuda.synchronize()
    assert kernels.LAUNCHES == {"qkv_attention": 1, "attention": 1,
                                "qkv_attention_bwd": 2}
    assert torch.isfinite(qkv.grad).all() and torch.isfinite(q.grad).all()


def test_cpu_backward_takes_the_plain_version_and_counts_no_launch():
    before = dict(kernels.LAUNCHES)
    qkv = torch.randn(2, 9, 3 * 32, requires_grad=True)
    g = torch.randn(2, 9, 32)
    fused_qkv_attention(qkv, 1).backward(g)
    torch.testing.assert_close(
        qkv.grad, qkv_attention_bwd_plain(qkv.detach(), g, 1), rtol=0, atol=0)
    assert dict(kernels.LAUNCHES) == before


def test_dense_bf16_grads_on_card_match_cpu(cuda):
    # the card's dense is an autograd Function; its gradients follow the
    # rounding of the CPU's autograd through the casts, which
    # tests/test_torch_clip.py::test_dense_bf16_grads_match_jax holds to
    # jax.vjp
    from eventclip_tpu_torch.models.clip.model import dense

    gen = torch.Generator().manual_seed(3)
    x = torch.randn((4, 16, 48), generator=gen).bfloat16()
    w = 0.05 * torch.randn((96, 48), generator=gen)
    b = torch.randn((96,), generator=gen)
    g = torch.randn((4, 16, 96), generator=gen).bfloat16()
    grads = []
    for dev in ("cpu", cuda):
        leaves = [t.detach().to(dev).requires_grad_() for t in (x, w, b)]
        dense(*leaves).backward(g.to(dev))
        grads.append([t.grad.float().cpu() for t in leaves])
    for want, got in zip(*grads):
        ulp = torch.finfo(torch.bfloat16).eps * want.abs()
        assert ((got - want).abs() <= ulp + 1e-6).all()


# -- D1, the bf16 dense product (csrc/dense.cu, ops/dense.py) ----------------


def _bf16_ulp(v):
    """One bf16 ulp at each value of v (float64): 2^(e - 7) for |v| in
    [2^e, 2^(e+1)); the smallest normal's at 0."""
    _, e = torch.frexp(v.float())
    return torch.ldexp(torch.ones_like(v), (e - 8).to(torch.int64)).clamp(
        min=2.0 ** -133)


def _dense_vs_exact(got, x, w, b, rows=16384):
    """Hold got [M, N] to the exact f64 product of the bf16 operands plus
    the f32 bias: every element within one bf16 ulp of the exact value
    plus the f32 sum's own bound, (K + 1) 2^-24 sum |x_i w_i| (+ |b|),
    which any order of f32 sums keeps; returns the elements whose bits are
    not the exact value's rounding."""
    K = x.shape[1]
    differ = 0
    for r0 in range(0, x.shape[0], rows):
        xs = x[r0:r0 + rows].double()
        exact = xs @ w.double().t()
        mag = xs.abs() @ w.double().abs().t()
        if b is not None:
            exact, mag = exact + b.double(), mag + b.double().abs()
        err = (got[r0:r0 + rows].double() - exact).abs()
        limit = _bf16_ulp(exact) + (K + 1) * 2.0 ** -24 * mag
        assert (err <= limit).all(), float((err / limit).max())
        differ += int((got[r0:r0 + rows]
                       != exact.float().bfloat16()).sum())
    return differ


@pytest.mark.parametrize("M,K,N,bias", [
    (82240, 1024, 3072, True),  # serving, 320 views x 257: q/k/v
    (82240, 1024, 1024, True),  # attention out
    (82240, 1024, 4096, True),  # MLP in
    (82240, 4096, 1024, True),  # MLP out
    (82240, 1024, 3072, False),
    (65792, 1024, 3072, True),  # FT, 256 views
    (65792, 4096, 1024, False),
    (7777, 768, 2304, True),  # text tower, 101 prompts x 77
    (7777, 3072, 768, False),
    (1, 1024, 1024, True),
    (1, 1024, 1024, False),
    (65, 1024, 3072, True),
    (65, 1024, 3072, False),
])
def test_dense_d1_rounds_the_exact_sum_on_card(cuda, M, K, N, bias):
    """D1 against the exact f64 product of the bf16 operands plus the f32
    bias: every element within one bf16 ulp (and the f32 sum's bound), and
    no more elements off the exact rounding than the library route
    (`addmm(out_dtype=f32)` then the cast) gives on the same inputs."""
    from eventclip_tpu_torch.ops import dense as DN

    gen = torch.Generator(device=cuda).manual_seed(M + K + N)
    x = torch.randn((M, K), generator=gen, device=cuda).bfloat16()
    w = (torch.randn((N, K), generator=gen, device=cuda) / K ** 0.5
         ).bfloat16()
    b = torch.randn((N,), generator=gen, device=cuda) if bias else None
    kernels.reset_launches()
    got = DN.dense_bf16(x, w, b)
    torch.cuda.synchronize()
    assert dict(kernels.LAUNCHES) == {"dense": 1}
    assert got.shape == (M, N) and got.dtype == torch.bfloat16
    lib = DN.library_dense(x, w, b)
    assert _dense_vs_exact(got, x, w, b) <= _dense_vs_exact(lib, x, w, b)


def test_dense_patch_embedding_keeps_the_library_gemm_on_card(cuda):
    """ViT-L/14's patch embedding (K = 588: 1,176-byte rows, no bias) is
    the one tower product D1 leaves: no launch, the library GEMM's bits,
    within one bf16 ulp of the exact sum."""
    from eventclip_tpu_torch.models.clip.model import dense
    from eventclip_tpu_torch.ops import dense as DN

    gen = torch.Generator(device=cuda).manual_seed(588)
    x = torch.randn((320, 256, 588), generator=gen, device=cuda).bfloat16()
    w = torch.randn((1024, 588), generator=gen, device=cuda) / 588 ** 0.5
    kernels.reset_launches()
    got = dense(x, w)
    torch.cuda.synchronize()
    assert dict(kernels.LAUNCHES) == {}
    x2, wb = x.reshape(-1, 588), w.bfloat16()
    assert torch.equal(got.reshape(-1, 1024), DN.library_dense(x2, wb, None))
    _dense_vs_exact(got.reshape(-1, 1024), x2, wb, None)


def test_dense_op_opcheck_and_launcher_on_card(cuda):
    """opcheck of `eventclip::dense_bf16`'s CUDA implementation (with and
    without the bias, D1's shapes and the library's), and the op is its
    launch, bit for bit, counting one launch each."""
    from torch.library import opcheck

    from eventclip_tpu_torch.ops import dense as DN

    gen = torch.Generator(device=cuda).manual_seed(11)
    for K, N in ((64, 96), (588, 40)):
        x = torch.randn((77, K), generator=gen, device=cuda).bfloat16()
        w = torch.randn((N, K), generator=gen, device=cuda).bfloat16()
        for b in (None, torch.randn((N,), generator=gen, device=cuda)):
            res = opcheck(torch.ops.eventclip.dense_bf16.default, (x, w, b))
            assert set(res.values()) == {"SUCCESS"}, res
            kernels.reset_launches()
            assert torch.equal(torch.ops.eventclip.dense_bf16(x, w, b),
                               DN.launch_dense(x, w, b))
            torch.cuda.synchronize()
            assert dict(kernels.LAUNCHES) == (
                {"dense": 2} if K == 64 else {})


def test_dense_launches_96_a_serving_request_on_card(cuda):
    """One request of 32 recordings at ViT-L/14 (bf16, the 320 bucket)
    runs 96 of its 97 products on D1: q/k/v, out and the two MLP products
    of 24 blocks; the patch embedding keeps the library GEMM."""
    import numpy as np

    from eventclip_tpu_torch.serve import Predictor

    pred = Predictor(_ZSL14(), ["a", "b", "c"], smoke=True, batch_size=32,
                     device=cuda)
    rng = np.random.default_rng(5)
    streams = [np.stack([rng.integers(0, 240, n), rng.integers(0, 180, n),
                         np.sort(rng.random(n)), rng.choice([-1.0, 1.0], n)],
                        axis=1).astype(np.float32)
               for n in rng.integers(190_000, 225_000, 32)]
    wins, valids = pred.gather_windows(streams)
    kernels.reset_launches()
    out = pred.predict_windows(wins, valids)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["dense"] == 96
    assert kernels.LAUNCHES["qkv_attention"] == 24
    assert np.isfinite(out["probs"]).all()


def _bf16_inputs(gen, shape, n, device):
    return [torch.randn(shape, generator=gen, device=device).bfloat16()
            for _ in range(n)]


@pytest.mark.parametrize("dh", [16, 32, 64])
@pytest.mark.parametrize("S", [1, 17, 63, 64, 65, 129, 257, 577])
def test_bf16_tensor_core_kernels_match_plain_on_card(cuda, S, dh):
    # S below, at and past one 64-row tile and one 16-key step, the pruned
    # serving shape's 129, ViT-L/14's 257 and ViT-L/14@336's 577, fused
    # layout
    gen = torch.Generator(device=cuda).manual_seed(S * dh)
    heads = 2
    qkv, g = _bf16_inputs(gen, (2, S, 3 * heads * dh), 1, cuda) + \
        _bf16_inputs(gen, (2, S, heads * dh), 1, cuda)
    _assert_matches([fused_qkv_attention(qkv, heads)],
                    [qkv_attention_plain(qkv, heads)], torch.bfloat16)
    got = qkv_attention_bwd(qkv, g, heads)
    assert torch.equal(got, qkv_attention_bwd(qkv, g, heads))
    _assert_matches(got.split(heads * dh, -1),
                    qkv_attention_bwd_plain(qkv, g, heads).split(heads * dh,
                                                                 -1),
                    torch.bfloat16)


@pytest.mark.parametrize("S,dh,masked", [
    (1, 16, False),
    (65, 32, False),
    (257, 64, False),
    (577, 64, False),
    (77, 16, True),  # causal, as the text towers
    (77, 64, True),
])
def test_bf16_bhsd_kernels_match_plain_on_card(cuda, S, dh, masked):
    # the [B, H, S, dh] layout (K4 forward, K3 backward) on the tensor cores
    gen = torch.Generator(device=cuda).manual_seed(S + dh)
    q, k, v, g = _bf16_inputs(gen, (2, 3, S, dh), 4, cuda)
    mask = causal_mask(S, device=cuda) if masked else None
    _assert_matches([multi_head_attention(q, k, v, mask)],
                    [attention_plain(q, k, v, mask)], torch.bfloat16)
    got = attention_bwd(q, k, v, g, mask)
    for a, b in zip(got, attention_bwd(q, k, v, g, mask)):
        assert torch.equal(a, b)
    _assert_matches(got, attention_bwd_plain(q, k, v, g, mask),
                    torch.bfloat16)


@pytest.mark.parametrize("dh", [16, 64])
def test_bf16_causal_fused_kernels_match_plain_on_card(cuda, dh):
    gen = torch.Generator(device=cuda).manual_seed(77 + dh)
    heads, S = 3, 77
    qkv, g = _bf16_inputs(gen, (4, S, 3 * heads * dh), 1, cuda) + \
        _bf16_inputs(gen, (4, S, heads * dh), 1, cuda)
    mask = causal_mask(S, device=cuda)
    _assert_matches([fused_qkv_attention(qkv, heads, mask)],
                    [qkv_attention_plain(qkv, heads, mask)], torch.bfloat16)
    got = qkv_attention_bwd(qkv, g, heads, mask)
    assert torch.equal(got, qkv_attention_bwd(qkv, g, heads, mask))
    _assert_matches(got.split(heads * dh, -1),
                    qkv_attention_bwd_plain(qkv, g, heads, mask)
                    .split(heads * dh, -1), torch.bfloat16)


def _resident_limits(dh, device):
    """Each bf16 kernel's largest S whose streamed operands it holds in
    shared memory (resident), from the plan the libraries give."""
    from eventclip_tpu_torch.ops.attention import ring_plan

    limits = {}
    for kind in ("fwd", "dq", "dkdv"):
        lo, hi = 1, 256  # in 64-row chunks: resident at lo, not at hi
        assert ring_plan(64 * lo, dh, device)[kind]["resident"]
        assert not ring_plan(64 * hi, dh, device)[kind]["resident"]
        while hi - lo > 1:
            mid = (lo + hi) // 2
            if ring_plan(64 * mid, dh, device)[kind]["resident"]:
                lo = mid
            else:
                hi = mid
        limits[kind] = 64 * lo
    return limits


@pytest.mark.parametrize("layout", ["fused", "[B, H, S, dh]"])
@pytest.mark.parametrize("dh", [16, 64])
def test_bf16_kernels_on_both_sides_of_the_resident_limit(cuda, dh, layout):
    # at each kernel's largest resident S and one row more, where that
    # kernel streams its operands through the ring instead: forward and
    # backward held to the plain versions, the backward twice, bit-equal
    from eventclip_tpu_torch.ops.attention import ring_plan

    limits = _resident_limits(dh, cuda)
    heads = 2
    for kind, limit in limits.items():
        for S in (limit, limit + 1):
            assert ring_plan(S, dh, cuda)[kind]["resident"] == (S == limit)
            gen = torch.Generator(device=cuda).manual_seed(S + dh)
            if layout == "fused":
                qkv, g = _bf16_inputs(gen, (1, S, 3 * heads * dh), 1, cuda) + \
                    _bf16_inputs(gen, (1, S, heads * dh), 1, cuda)
                _assert_matches([fused_qkv_attention(qkv, heads)],
                                [qkv_attention_plain(qkv, heads)],
                                torch.bfloat16)
                got = qkv_attention_bwd(qkv, g, heads)
                assert torch.equal(got, qkv_attention_bwd(qkv, g, heads))
                _assert_matches(got.split(heads * dh, -1),
                                qkv_attention_bwd_plain(qkv, g, heads)
                                .split(heads * dh, -1), torch.bfloat16)
            else:
                q, k, v, g = _bf16_inputs(gen, (1, heads, S, dh), 4, cuda)
                _assert_matches([multi_head_attention(q, k, v)],
                                [attention_plain(q, k, v)], torch.bfloat16)
                got = attention_bwd(q, k, v, g)
                for a, b in zip(got, attention_bwd(q, k, v, g)):
                    assert torch.equal(a, b)
                _assert_matches(got, attention_bwd_plain(q, k, v, g),
                                torch.bfloat16)


def test_misaligned_bf16_rows_raise_on_card(cuda):
    # a view 2 bytes past a 16-byte boundary: the tensor-core kernels'
    # 16-byte copies cannot take it, and no other kernel is tried
    B, S, D = 2, 9, 64
    flat = torch.zeros(B * S * 3 * D + 1, dtype=torch.bfloat16, device=cuda)
    qkv = flat[1:].view(B, S, 3 * D)
    g = torch.zeros(B, S, D, dtype=torch.bfloat16, device=cuda)
    kernels.reset_launches()
    with pytest.raises(ValueError, match="16-byte"):
        fused_qkv_attention(qkv, 1)
    with pytest.raises(ValueError, match="16-byte"):
        qkv_attention_bwd(qkv, g, 1)
    misaligned_g = flat[1:B * S * D + 1].view(B, S, D)
    with pytest.raises(ValueError, match="16-byte"):
        qkv_attention_bwd(torch.zeros_like(flat[:B * S * 3 * D])
                          .view(B, S, 3 * D), misaligned_g, 1)
    q = flat[1:B * S * D + 1].view(B, 1, S, D)
    k = torch.zeros_like(q)
    with pytest.raises(ValueError, match="16-byte"):
        multi_head_attention(q, k, k)
    assert dict(kernels.LAUNCHES) == {}


@pytest.mark.parametrize("M,K,N", [
    (2 * 256, 588, 1024),  # ViT-L/14 patch_embed: K = 3 * 14 * 14
    (2 * 257, 1024, 3072),  # a block's wqkv
    (2 * 257, 4096, 1024),  # a block's w2
    (5, 588, 20),  # M <= 16 and N off the multiple of 8
])
def test_int8_product_on_card_equals_cpu(cuda, monkeypatch, M, K, N):
    """W8A8 `qdense` through `torch._int_mm` on the card (cuBLASLt int8:
    M > 16, K and N multiples of 8, so `_int_mm` pads): the int32 sums
    equal the exact integer product, and the whole product equals the CPU
    route bit for bit on the same bf16 activations (the quantize and the
    rescale are the same IEEE arithmetic; the CPU's int8 product is
    replaced by the exact integer one, so only the card is under test)."""
    from eventclip_tpu_torch.ops import quant

    gen = torch.Generator().manual_seed(K + N)
    xq = torch.randint(-127, 128, (M, K), generator=gen, dtype=torch.int8)
    w = torch.randint(-127, 128, (N, K), generator=gen, dtype=torch.int8)
    y = quant._int_mm(xq.to(cuda), w.to(cuda).t())
    assert y.dtype == torch.int32
    exact = xq.int() @ w.int().t()
    assert torch.equal(y.cpu(), exact), (y.cpu() != exact).sum()

    x = torch.randn((M, K), generator=gen).bfloat16()
    wf = 0.02 * torch.randn((N, K), generator=gen)
    b = torch.randn((N,), generator=gen)
    qw, qw_card = quant.quantize_weight(wf), quant.quantize_weight(wf.to(cuda))
    with monkeypatch.context() as m:
        m.setattr(quant, "_int_mm", lambda a, bt: a.int() @ bt.int())
        want = quant.qdense(x, qw, b)
    got = quant.qdense(x.to(cuda), qw_card, b.to(cuda))
    assert got.dtype == torch.bfloat16 and got.shape == (M, N)
    assert torch.equal(qw_card.q.cpu(), qw.q)  # weights quantized alike
    assert torch.equal(qw_card.s.cpu(), qw.s)
    diff = (got.cpu().float() - want.float()).abs()
    assert torch.equal(got.cpu(), want), (int((diff > 0).sum()),
                                          float(diff.max()))


def test_pruned_attention_shape_matches_plain_on_card(cuda):
    """K2 at the pruned serving shape (128 of 256 patches + the class
    token: S = 129), bf16, held to chip_smoke's limits."""
    gen = torch.Generator(device=cuda).manual_seed(129)
    qkv = torch.randn((32, 129, 3072), generator=gen, device=cuda).bfloat16()
    _assert_matches([fused_qkv_attention(qkv, 16)],
                    [qkv_attention_plain(qkv, 16)], torch.bfloat16)


# -- the custom ops (ops/custom_ops.py) on the card --------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("masked", [False, True])
def test_opcheck_each_op_on_card(cuda, dtype, masked):
    """torch.library.opcheck of every op's CUDA implementation: schema,
    autograd registration (K3 as the registered formula), fake
    implementation, AOT dispatch."""
    from torch.library import opcheck

    ops = torch.ops.eventclip
    gen = torch.Generator(device=cuda).manual_seed(int(masked))
    S = 77
    m = causal_mask(S, device=cuda) if masked else None
    qkv = torch.randn((4, S, 3 * 128), generator=gen, device=cuda).to(
        dtype).requires_grad_()
    q, k, v = (torch.randn((4, 2, S, 64), generator=gen, device=cuda)
               .to(dtype).requires_grad_() for _ in range(3))
    g = torch.randn((4, S, 128), generator=gen, device=cuda).to(dtype)
    for op, args in (
            (ops.qkv_attention.default, (qkv, 2, m)),
            (ops.attention.default, (q, k, v, m)),
            (ops.qkv_attention_bwd.default, (qkv.detach(), g, 2, m)),
            (ops.attention_bwd.default, (q.detach(), k.detach(), v.detach(),
                                         torch.randn_like(q), m)),
            (ops.event_histogram.default,
             (_windows(gen, 8, 5000, 180, 240, cuda), 180, 240))):
        res = opcheck(op, args)
        assert set(res.values()) == {"SUCCESS"}, (op, res)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_custom_ops_equal_their_launchers_on_card(cuda, dtype):
    """Each op's CUDA implementation is its ctypes launch, bit for bit,
    counting one launch each."""
    from eventclip_tpu_torch.ops import attention as A
    from eventclip_tpu_torch.ops.rasterize import (device_histogram_plan,
                                                   launch_histograms)

    gen = torch.Generator(device=cuda).manual_seed(7)
    qkv = torch.randn((8, 257, 3 * 1024), generator=gen, device=cuda).to(
        dtype)
    g = torch.randn((8, 257, 1024), generator=gen, device=cuda).to(dtype)
    q, k, v = (torch.randn((8, 16, 257, 64), generator=gen, device=cuda)
               .to(dtype) for _ in range(3))
    wins = _windows(gen, 32, 20000, 180, 240, cuda)
    plan = device_histogram_plan(cuda, 180, 240)
    kernels.reset_launches()
    pairs = [
        (fused_qkv_attention(qkv, 16), A.launch_qkv_attention(qkv, 16, None)),
        (qkv_attention_bwd(qkv, g, 16),
         A.launch_qkv_attention_bwd(qkv, g, 16, None)),
        (multi_head_attention(q, k, v), A.launch_attention(q, k, v, None)),
        (torch.cat(attention_bwd(q, k, v, q)),
         torch.cat(A.launch_attention_bwd(q, k, v, q, None))),
        (histograms(wins, 180, 240), launch_histograms(wins, 180, 240, plan)),
    ]
    torch.cuda.synchronize()
    for got, want in pairs:
        assert torch.equal(got, want)
    assert kernels.LAUNCHES == {"qkv_attention": 2, "qkv_attention_bwd": 4,
                                "attention": 2, "histogram": 2}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("masked", [False, True])
def test_grad_through_k3_registered_formula_on_card(cuda, dtype, masked):
    """torch.autograd.grad through eventclip::qkv_attention runs K3 (its
    registered autograd formula): the ctypes launch bit for bit, within
    the limits of the plain backward; a learned mask's cotangent comes
    from the plain formula."""
    from eventclip_tpu_torch.ops import attention as A

    gen = torch.Generator(device=cuda).manual_seed(3 + masked)
    S = 77
    qkv = torch.randn((4, S, 3 * 128), generator=gen, device=cuda).to(
        dtype).requires_grad_()
    g = torch.randn((4, S, 128), generator=gen, device=cuda).to(dtype)
    mask = None
    if masked:
        mask = (0.1 * torch.randn((S, S), generator=gen, device=cuda)
                + causal_mask(S, device=cuda)).requires_grad_()
    kernels.reset_launches()
    out = torch.ops.eventclip.qkv_attention(qkv, 2, mask)
    grads = torch.autograd.grad(out, (qkv, mask) if masked else (qkv,), g)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES == {"qkv_attention": 1, "qkv_attention_bwd": 1}
    md = None if mask is None else mask.detach()
    assert torch.equal(grads[0], A.launch_qkv_attention_bwd(
        qkv.detach(), g, 2, md))
    _assert_matches([grads[0]], [qkv_attention_bwd_plain(qkv.detach(), g, 2,
                                                         md)], dtype)
    if masked:
        want = A.mask_cotangent(*A._split_heads(qkv.detach(), 2), md,
                                g.reshape(4, S, 2, -1).transpose(1, 2))
        torch.testing.assert_close(grads[1], want, rtol=0, atol=0)


# -- export bundles on the card (export.py) -----------------------------------


@pytest.mark.parametrize("loaded_on", ["cuda", "cpu"])
@pytest.mark.parametrize("exported_on", ["cuda", "cpu"])
def test_exported_bundle_launches_the_kernels_on_card(cuda, tmp_path,
                                                      monkeypatch,
                                                      exported_on,
                                                      loaded_on):
    """A bundle listing both device types, exported on the card (bf16: a
    graph set traced on the card, whose bf16 products are
    `eventclip::dense_bf16` nodes, and one traced on the CPU) or on a host
    without a card (f32, `torch.cuda.is_available` patched off: the CPU's
    set alone, moved to the card at load), loaded on the card or on the
    CPU. On the card it launches K1 and K2, the `eventclip::` nodes of its
    graphs, and D1 for the card set's products, and answers as the live card predictor on the same leaves:
    probabilities atol 1e-5, or 1e-4 for the moved f32 graph (the export
    CLI's --check limit: other graph, other summation order). On the CPU
    it launches nothing and answers as the live CPU predictor on the same
    leaves, atol 1e-5 (the same ops). The CPU's set holds no `mm.dtype`
    and no constant off the CPU; the card's set holds D1's op and no
    `mm.dtype`."""
    import io
    import zipfile

    import numpy as np

    from eventclip_tpu_torch import export
    from eventclip_tpu_torch.export import ExportedPredictor, export_predictor
    from eventclip_tpu_torch.serve import Predictor
    from eventclip_tpu_torch.utils.config import Params

    class TinyZS(Params):  # tests/test_server.py's _TinyZS
        gpus = 1
        dataset = "n_caltech"
        train_batch_size = 4
        val_batch_size = 8
        data_root = "/nonexistent"
        quantize_args = dict(
            max_imgs=2, N=1000, split_method="event_count",
            convert_method="event_histogram", grayscale=True,
            count_non_zero=False, background_mask=True)
        model = "ZSCLIP"
        clip_dict = dict(arch="ViT-T/8@32",
                         prompt="a point cloud image of a {}",
                         agg_func="mean")
        bf16 = exported_on == "cuda"

    live = Predictor(TinyZS(), ["a", "b", "c"], smoke=True, batch_size=4,
                     device=exported_on)
    path = str(tmp_path / "b.eclip")
    with monkeypatch.context() as m:
        if exported_on == "cpu":
            m.setattr(export.torch.cuda, "is_available", lambda: False)
        meta = export_predictor(live, path, platforms=["cuda", "cpu"])
    sets = {p: s["set"] for p, s in meta["sets"].items()}
    assert sets == ({"cuda": "cuda", "cpu": "cpu"} if exported_on == "cuda"
                    else {"cuda": "cpu", "cpu": "cpu"})
    with zipfile.ZipFile(path) as z:
        for name in z.namelist():
            if not name.endswith(".pt2"):
                continue
            ep = torch.export.load(io.BytesIO(z.read(name)))
            targets = {str(n.target) for n in ep.graph.nodes}
            if name.startswith("cpu/"):
                assert "aten.mm.dtype" not in targets, name
                assert {t.device.type for t in ep.constants.values()
                        if isinstance(t, torch.Tensor)} <= {"cpu"}, name
            elif name == "cuda/step.pt2":
                assert "eventclip.dense_bf16.default" in targets
                assert "aten.mm.dtype" not in targets
    frozen = ExportedPredictor(path, device=loaded_on)
    want_pred = live if loaded_on == exported_on else live.on_device(
        loaded_on)
    rng = np.random.default_rng(5)
    streams = [np.stack([rng.integers(0, 240, n), rng.integers(0, 180, n),
                         np.sort(rng.random(n)), rng.choice([-1.0, 1.0], n)],
                        axis=1).astype(np.float32)
               for n in (700, 3000, 12000)]
    kernels.reset_launches()
    got = frozen.predict(streams)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    if loaded_on == "cuda":
        layers = live._cfg.clip.vision.layers
        assert launches["histogram"] >= 1
        assert launches["qkv_attention"] >= layers
        assert launches["qkv_attention"] % layers == 0
        # the card's set runs its bf16 products on D1; the moved f32 set
        # has none
        if exported_on == "cuda":
            assert launches["dense"] >= 4 * layers
        else:
            assert "dense" not in launches
    else:
        assert not any(launches.values()), launches
    want = want_pred.predict(streams)
    np.testing.assert_array_equal(got["label"], want["label"])
    moved = exported_on == "cpu" and loaded_on == "cuda"
    np.testing.assert_allclose(got["probs"], want["probs"], rtol=0,
                               atol=1e-4 if moved else 1e-5)


# -- data-parallel training and the trainer extras (parallel/, utils/viz) ---


def test_one_rank_nccl_steps_equal_plain_steps_on_card(cuda, tmp_path):
    """Two FT steps (ViT-T/8@32, f32, RandAugment on) under a one-rank
    NCCL group give the trainable leaves of the same steps with no group,
    bit for bit (a one-rank mean is a copy), through K1, K2 and K3."""
    import socket

    from eventclip_tpu_torch.engine.checkpoint import trainable_flat
    from eventclip_tpu_torch.parallel import distributed as D
    from tests.torch_ddp_worker import build_trainer

    def run(tag):
        t = build_trainer("ft", str(tmp_path / tag), visualize=False,
                          device=cuda)
        kernels.reset_launches()
        t.train_epoch(0)
        torch.cuda.synchronize()
        return (trainable_flat(t.cls_cfg, t.model_params),
                dict(kernels.LAUNCHES), t.optimizer.count)

    plain, _, n = run("plain")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    D.initialize_distributed(f"localhost:{port}", 1, 0, backend="nccl",
                             device=cuda)
    try:
        assert D.is_distributed() and D.host_shard_info() == (0, 1)
        got, launches, m = run("nccl")
    finally:
        D.shutdown_distributed()
    assert n == m == 2
    for k, v in plain.items():
        assert (got[k] == v).all(), k
    assert launches["histogram"] == 2
    assert launches["qkv_attention"] > 0 and launches["qkv_attention_bwd"] > 0


def test_viz_forward_launches_the_kernels_on_card(cuda, tmp_path):
    """The trainer's validation GIFs run the card's forward: K1 for each
    sample's probabilities and inputs, K2 for each layer of its tower.
    Without PIL the first GIF write fails after that sample's forwards."""
    from tests.torch_ddp_worker import build_trainer

    t = build_trainer("fs", str(tmp_path), device=cuda, n_samples=2)
    kernels.reset_launches()
    try:
        t._sample_events()
    except ImportError:
        pass
    torch.cuda.synchronize()
    probs, inputs = t.viz_forwards
    assert probs >= 1
    assert kernels.LAUNCHES["histogram"] == probs + inputs
    assert kernels.LAUNCHES["qkv_attention"] == \
        probs * t.clip_cfg.vision.layers


# -- tensor parallelism and the local split -----------------------------------


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_tp_attention_matches_plain_on_card(cuda, dtype):
    """One model rank of ViT-L/14 over two: its [B, 257, 3·1024/2] fused
    qkv with 16 / 2 heads through `tp_fused_qkv_attention`, forward (K2)
    and gradient (K3) against the plain versions at 8 heads."""
    from eventclip_tpu_torch.ops.attention import tp_fused_qkv_attention
    from eventclip_tpu_torch.parallel.sharding import TPContext

    tp = TPContext(n_data=1, n_model=2, data_index=0, model_index=1)
    gen = torch.Generator(device=cuda).manual_seed(3)
    qkv = torch.randn((4, 257, 1536), generator=gen, device=cuda).to(dtype)
    g = torch.randn((4, 257, 512), generator=gen, device=cuda).to(dtype)
    x = qkv.clone().requires_grad_()
    kernels.reset_launches()
    out = tp_fused_qkv_attention(x, 16, tp)
    out.backward(g)
    assert kernels.LAUNCHES["qkv_attention"] == 1
    assert kernels.LAUNCHES["qkv_attention_bwd"] == 1
    _assert_matches([out.detach()], [qkv_attention_plain(qkv, 8)], dtype)
    _assert_matches(x.grad.split(512, -1),
                    qkv_attention_bwd_plain(qkv, g, 8).split(512, -1), dtype)


@pytest.mark.parametrize("dh", [16, 64])
def test_tp_slice_at_an_odd_head_matches_plain_on_card(cuda, dh):
    """A model rank of 6 heads over two: the rank's fused [B, S, 3 * 3 dh]
    has its k and v column blocks start at its third head (96 or 384 bytes
    into a row, off the 128-byte lines the tensor maps' swizzle spans),
    forward and gradient held to the plain versions at 3 heads."""
    from eventclip_tpu_torch.ops.attention import tp_fused_qkv_attention
    from eventclip_tpu_torch.parallel.sharding import TPContext

    tp = TPContext(n_data=1, n_model=2, data_index=0, model_index=1)
    gen = torch.Generator(device=cuda).manual_seed(5 + dh)
    D = 3 * dh  # the rank's width
    qkv, g = _bf16_inputs(gen, (4, 257, 3 * D), 1, cuda) + \
        _bf16_inputs(gen, (4, 257, D), 1, cuda)
    x = qkv.clone().requires_grad_()
    out = tp_fused_qkv_attention(x, 6, tp)
    out.backward(g)
    _assert_matches([out.detach()], [qkv_attention_plain(qkv, 3)],
                    torch.bfloat16)
    _assert_matches(x.grad.split(D, -1),
                    qkv_attention_bwd_plain(qkv, g, 3).split(D, -1),
                    torch.bfloat16)


def test_local_split_on_one_card_twice(cuda):
    """A LocalSplit over [cuda:0, cuda:0] (two parts, one replica) against
    the unsplit forward on the card, f32 ViT-T/8@32: each part launches
    K1 once and K2 once a layer."""
    from eventclip_tpu_torch.models import classifier
    from eventclip_tpu_torch.models.clip.config import clip_arch_config
    from eventclip_tpu_torch.ops.preprocess import ClipPreprocess
    from eventclip_tpu_torch.ops.rasterize import RasterSpec
    from eventclip_tpu_torch.parallel.local import LocalSplit

    cfg = classifier.ClassifierConfig(model="ZSCLIP",
                                      clip=clip_arch_config("ViT-T/8@32"))
    p = classifier.init_classifier_params(
        cfg, torch.Generator(device=cuda).manual_seed(0), n_classes=4)
    spec, pp = RasterSpec(height=24, width=32, window=64), \
        ClipPreprocess(24, 32, 32)
    gen = torch.Generator(device=cuda).manual_seed(1)
    wins = torch.stack([torch.randint(0, 32, (4, 2, 64), generator=gen,
                                      device=cuda),
                        torch.randint(0, 24, (4, 2, 64), generator=gen,
                                      device=cuda),
                        torch.ones(4, 2, 64, dtype=torch.int64,
                                   device=cuda)], -1).to(torch.int16)
    valid = torch.ones(4, 2, dtype=torch.bool, device=cuda)
    one = LocalSplit(p, [cuda]).forward(cfg, spec, pp, wins, valid)
    kernels.reset_launches()
    two = LocalSplit(p, [cuda, cuda]).forward(cfg, spec, pp, wins, valid)
    assert kernels.LAUNCHES["histogram"] == 2
    assert kernels.LAUNCHES["qkv_attention"] == 2 * 2
    torch.testing.assert_close(two["view_feats"], one["view_feats"],
                               rtol=1e-5, atol=1e-6)


# -- the program's spans on the profiler's clock (utils/spans.py) ----------


def _device_kernels(prof):
    cuda_t = torch.autograd.DeviceType.CUDA
    return sorted(((e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
                   for e in prof.profiler.kineto_results.events()
                   if e.device_type() == cuda_t and e.duration_ns() > 0
                   and "emcpy" not in e.name() and "emset" not in e.name()),
                  key=lambda k: k[1])


def test_spans_share_the_device_traces_clock_on_card(cuda):
    """Under torch.profiler: a kernel launched and waited for inside a
    span lies inside it on the trace's clock, and the span ends under
    1 ms after the kernel. Then one serving request at ViT-L/14 (16
    recordings of 200k events, 160 views: the card runs behind the host):
    its `serve.fetch` span, the host waiting for the card, covers the
    step's last kernel."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from eventclip_tpu_torch.serve import Predictor
    from eventclip_tpu_torch.utils import spans

    pred = Predictor(_ZSL14(), ["a", "b", "c"], smoke=True, batch_size=16,
                     device=cuda)
    rng = np.random.default_rng(3)
    streams = [np.stack([rng.integers(0, 240, n), rng.integers(0, 180, n),
                         np.sort(rng.random(n)), rng.choice([-1.0, 1.0], n)],
                        axis=1).astype(np.float32)
               for n in rng.integers(200_000, 220_000, 16)]
    wins, valids = pred.gather_windows(streams)
    want = pred.predict_windows(wins, valids)  # warm: allocator, libraries
    torch.cuda.synchronize()
    spans.clear()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with spans.span("probe"):
            torch.cuda._sleep(20_000_000)
            torch.cuda.synchronize()
        got = pred.predict_windows(wins, valids)
    recs = {r.name: r for r in spans.records()}
    spans.clear()
    np.testing.assert_allclose(got["probs"], want["probs"], rtol=0,
                               atol=1e-6)
    ks = _device_kernels(prof)
    (_, a, b), = [k for k in ks if "spin" in k[0]]
    probe = recs["probe"]
    assert probe.start_ns <= a and b <= probe.end_ns, (probe, a, b)
    assert probe.end_ns - b < 1_000_000, probe.end_ns - b
    fetch, enqueue = recs["serve.fetch"], recs["serve.enqueue"]
    step = [k for k in ks if enqueue.start_ns <= k[1] <= fetch.end_ns]
    # the card runs behind: most of the step's kernels, enqueued before
    # the fetch began, run while the host waits in it
    assert len([k for k in step if k[1] >= fetch.start_ns]) > 24
    name, a, b = max(step, key=lambda k: k[2])
    assert fetch.start_ns <= a and b <= fetch.end_ns, (name, fetch, a, b)
    assert fetch.end_ns - b < 5_000_000, fetch.end_ns - b
