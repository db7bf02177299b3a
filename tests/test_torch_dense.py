"""`eventclip::dense_bf16` (ops/dense.py, D1 csrc/dense.cu) on the CPU.

The op is registered with its CPU implementation (the plain version,
bit-equal to `dense`'s CPU route), its fake implementation (shapes under
`torch.export`) and its CUDA implementation, which runs on the card only
(tests/test_torch_card.py). The route rule and the tile plan are pure
functions of the shape, checked here on the shapes of every path: the
serving and fine-tuning towers (ViT-L/14, M = 82,240 and 65,792 tokens),
the text tower (M = 7,777), the few-shot adapter and the tiny cases.
"""

import pytest
import torch
from torch.library import opcheck

from eventclip_tpu_torch.models.clip import model
from eventclip_tpu_torch.ops import dense as D

OPS = torch.ops.eventclip

# (K, N) of a ViT-L/14 block's products: q/k/v, out, MLP in, MLP out
VITL14 = [(1024, 3072), (1024, 1024), (1024, 4096), (4096, 1024)]
# the text tower's (width 768)
TEXT = [(768, 2304), (768, 768), (768, 3072), (3072, 768)]


def _inputs(seed, M, K, N, bias=True):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((M, K), generator=gen).bfloat16()
    w = (0.05 * torch.randn((N, K), generator=gen)).bfloat16()
    b = torch.randn((N,), generator=gen) if bias else None
    return x, w, b


def test_dense_op_is_registered():
    assert hasattr(OPS, "dense_bf16")
    schema = str(OPS.dense_bf16.default._schema)
    assert schema.startswith("eventclip::dense_bf16(Tensor x2, Tensor w, "
                             "Tensor? b)"), schema


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("M,K,N", [(5, 48, 96), (1, 16, 8), (37, 588, 40)])
def test_opcheck_dense_op(M, K, N, bias):
    res = opcheck(OPS.dense_bf16.default, _inputs(M, M, K, N, bias))
    assert set(res.values()) == {"SUCCESS"}, res


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("M,K,N", [(64, 48, 96), (65, 32, 8), (1, 64, 64),
                                   (37, 588, 40)])
def test_dense_op_on_cpu_equals_the_cpu_dense(M, K, N, bias):
    """The op's CPU implementation gives the bits of `dense`'s CPU route
    (the f32 product of the rounded operands plus the f32 bias, rounded
    once), which tests/test_torch_clip.py holds to the JAX `dense`."""
    x, w, b = _inputs(K + N, M, K, N, bias)
    want = model.dense(x, w.float(), b)
    assert want.dtype == torch.bfloat16
    assert torch.equal(OPS.dense_bf16(x, w, b), want)
    assert torch.equal(D.dense_bf16(x, w, b), want)
    assert torch.equal(D.dense_plain(x, w, b), want)


class _Products(torch.nn.Module):
    """The card route's products as `dense` calls them (`_dense_f32_acc`)."""

    def __init__(self, shapes, bias):
        super().__init__()
        self.shapes, self.bias = shapes, bias

    def forward(self, x, *params):
        for i, (_, n) in enumerate(self.shapes):
            w = params[2 * i]
            b = params[2 * i + 1] if self.bias else None
            x = model._dense_f32_acc(x, w, b)
        return x


@pytest.mark.parametrize("bias", [True, False])
def test_traced_card_route_keeps_one_op_node_a_product(bias):
    """`torch.export` (the fake implementation) keeps each product of the
    card's route as one `eventclip::dense_bf16` node with its [M, N] bf16
    shape, also through `run_decompositions`, and never `mm` with an
    `out_dtype`."""
    shapes = [(48, 96), (96, 32), (32, 40)]
    x = torch.randn((7, 48)).bfloat16()
    params = []
    for k, n in shapes:
        params += [(0.1 * torch.randn(n, k)).bfloat16(), torch.randn(n)]
    mod = _Products(shapes, bias)
    with torch.no_grad():
        ep = torch.export.export(mod, (x, *params))
    for graph in (ep.graph, ep.run_decompositions().graph):
        nodes = [n for n in graph.nodes
                 if str(n.target) == "eventclip.dense_bf16.default"]
        assert [tuple(n.meta["val"].shape) for n in nodes] == [
            (7, n) for _, n in shapes]
        assert all(n.meta["val"].dtype == torch.bfloat16 for n in nodes)
        targets = {str(n.target) for n in graph.nodes}
        assert "aten.mm.dtype" not in targets
        assert "aten.addmm.dtype" not in targets
    with torch.no_grad():
        assert torch.equal(ep.module()(x, *params), mod(x, *params))


def test_cpu_block_trace_holds_no_dense_op():
    """`dense` on CPU tensors is its plain route (the CPU's graph set is
    unchanged): no `eventclip::dense_bf16` node in a traced bf16 block."""
    from eventclip_tpu_torch.models.clip.model import Block

    blk = Block(64, 2)
    x = torch.randn((2, 9, 64)).bfloat16()
    with torch.no_grad():
        ep = torch.export.export(blk, (x,))
    targets = {str(n.target) for n in ep.graph.nodes}
    assert "eventclip.dense_bf16.default" not in targets
    assert "eventclip.qkv_attention.default" in targets


@pytest.mark.parametrize("K,N", VITL14 + TEXT + [
    (32, 8), (512, 512), (64, 16)])
def test_d1_takes_every_tower_product(K, N):
    assert D.d1_takes(torch.bfloat16, N, K)


@pytest.mark.parametrize("dtype,K,N,why", [
    (torch.bfloat16, 588, 1024, "ViT-L/14 patch embedding: 1,176-byte rows"),
    (torch.bfloat16, 1024, 4, "a rank-4 LoRA factor's 8-byte output rows"),
    (torch.bfloat16, 4, 1024, "8-byte input rows"),
    (torch.bfloat16, 1020, 1024, "2,040-byte input rows"),
    (torch.bfloat16, 1024, 1, "one output feature"),
    (torch.bfloat16, 0, 1024, "no input features"),
    (torch.float16, 1024, 1024, "not bf16"),
    (torch.float32, 1024, 1024, "f32 (its own route, F.linear)"),
])
def test_d1_leaves_the_shapes_tma_cannot_copy(dtype, K, N, why):
    assert not D.d1_takes(dtype, N, K), why


@pytest.mark.parametrize("M,N,sms,want", [
    (82240, 3072, 132, (256, 132)),  # serving, 320 views x 257 tokens
    (82240, 1024, 132, (256, 132)),
    (82240, 4096, 132, (256, 132)),
    (65792, 1024, 132, (256, 132)),  # FT, 256 views
    (65792, 4096, 132, (256, 132)),
    (7777, 2304, 132, (128, 132)),  # text tower: 5 rounds x 256 > 9 x 128
    (7777, 3072, 132, (256, 132)),  # 6 x 256 = 12 x 128
    (7777, 768, 132, (128, 132)),  # 2 x 256 > 3 x 128
    (2056, 1024, 132, (256, 68)),  # 1 x 256 = 2 x 128
    (64, 256, 132, (128, 2)),  # FS adapter, 32 x 2 views
    (65, 1024, 132, (128, 8)),
    (1, 1024, 132, (128, 8)),
    (1, 8, 132, (128, 1)),
])
def test_dense_plan_adapts_to_the_shape(M, N, sms, want):
    assert D.dense_plan(M, N, sms) == want


def test_dense_plan_fills_the_card_and_covers_the_output():
    for M in (1, 64, 65, 128, 129, 7777, 65792, 82240):
        for N in (8, 768, 1024, 2304, 3072, 4096):
            for sms in (114, 132):
                width, blocks = D.dense_plan(M, N, sms)
                tiles = {w: -(-M // D.TILE_ROWS) * -(-N // w)
                         for w in D.TILE_WIDTHS}
                assert width in D.TILE_WIDTHS
                assert blocks == min(tiles[width], sms)
                # the narrow tiles only where their rounds cost a tenth less
                rounds = {w: -(-t // sms) * w for w, t in tiles.items()}
                assert (width == 128) == (rounds[128] <= 0.9 * rounds[256])


def test_dense_op_checks_its_arguments():
    x, w, b = _inputs(0, 4, 16, 8)
    with pytest.raises(ValueError, match="x2 \\[M, K\\]"):
        D.dense_bf16(x, w[:, :8], b)
    with pytest.raises(ValueError, match="low-precision"):
        D.dense_bf16(x.float(), w.float(), b)
    with pytest.raises(ValueError, match="bias"):
        D.dense_bf16(x, w, b.bfloat16())
