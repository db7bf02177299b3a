"""Each CUDA kernel vs its plain PyTorch version, on the card.

These skip without a CUDA device. The file imports neither JAX nor the JAX
package, so it also runs on a machine without them:

    python -m pytest --noconftest tests/test_torch_card.py -q

Tolerances: the histogram is exact; attention f32 atol 1e-5, bf16 atol
2e-2 (the kernel and the plain version sum in different orders, and bf16
rounds p and the output).
"""

import pytest
import torch

from eventclip_tpu_torch.models.clip.model import causal_mask
from eventclip_tpu_torch.ops.attention import (
    fused_qkv_attention,
    qkv_attention_plain,
)
from eventclip_tpu_torch.ops.rasterize import histograms, histograms_plain

TOL = {"float32": 1e-5, "bfloat16": 2e-2}


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
    got = fused_qkv_attention(qkv, heads, mask)
    want = qkv_attention_plain(qkv, heads, mask)
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=TOL[str(dtype).split(".")[-1]])


@pytest.mark.parametrize("H,W", [(180, 240), (100, 120), (480, 640)])
def test_histogram_kernel_matches_plain_on_card(cuda, H, W):
    gen = torch.Generator(device=cuda).manual_seed(H)
    M, N = 4, 5000
    wins = torch.stack([
        torch.randint(-20, W + 20, (M, N), generator=gen, device=cuda),
        torch.randint(-20, H + 20, (M, N), generator=gen, device=cuda),
        torch.randint(-1, 2, (M, N), generator=gen, device=cuda),
    ], -1).to(torch.int16).contiguous()
    assert torch.equal(histograms(wins, H, W), histograms_plain(wins, H, W))


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
