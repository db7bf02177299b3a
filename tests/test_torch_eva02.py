"""The EVA02-CLIP image tower (models/clip/eva.py), its rotary op
(`eventclip::rope_qkv`, ops/rope.py), the EVA-CLIP key map
(models/clip/convert.py) and the exact-GELU text tower, held to the plain
reference `portbench/reference/eva02.py` on the CPU, on seeded random
weights at the debug towers: EVA02-T/8@48 (a hidden of 170, not a multiple
of 8, stored as 176; a grid of 6 whose rotary positions are interpolated
to 4) and EVA02-T/8@32 (a grid of 4 at 4). The float32 tower is held to
the reference within 1e-5 relative, and each of `portbench/faults_eva.py`'s
faults fails that comparison. Cases named `*_on_card` need a CUDA device
(the rotary kernel against its plain version, the tower's launches) and
skip elsewhere; the SwiGLU glue's op has its own file,
tests/test_torch_swiglu.py."""

import dataclasses

import numpy as np
import pytest
import torch
from torch.library import opcheck

from eventclip_tpu_torch import kernels
from eventclip_tpu_torch.models.classifier import (build_classifier_config,
                                                   classifier_forward,
                                                   init_classifier_params)
from eventclip_tpu_torch.models.clip import eva
from eventclip_tpu_torch.models.clip.config import (CLIP_ARCHS, EVA_ARCHS,
                                                    clip_arch_config)
from eventclip_tpu_torch.models.clip.convert import (eva_visual_state_dict,
                                                     load_eva_visual_)
from eventclip_tpu_torch.models.clip.eva import EVABlock, swiglu
from eventclip_tpu_torch.models.clip.model import (CLIP, encode_image,
                                                   encode_text,
                                                   init_clip_params)
from eventclip_tpu_torch.ops.rope import rope_qkv, rope_tables
from eventclip_tpu_torch.serve import Predictor
from eventclip_tpu_torch.utils.config import Params
from portbench import faults_eva, streams, weights_eva
from portbench.reference import eva02

DEBUG = ("EVA02-T/8@48", "EVA02-T/8@32")


def tower_config(arch):
    v = clip_arch_config(arch).vision
    vision = {k: getattr(v, k) for k in (
        "image_size", "patch_size", "width", "layers", "heads", "output_dim",
        "mlp_hidden", "rope_theta", "pt_hw_seq_len", "eps")}
    init = {k: [0.0, 0.1] for k in (
        "patch_embed.proj.weight", "patch_embed.proj.bias", "cls_token",
        "pos_embed", "attn.v_proj.weight", "attn.q_bias", "attn.v_bias",
        "attn.proj.weight", "attn.proj.bias", "mlp.w1.weight", "mlp.w1.bias",
        "mlp.w2.weight", "mlp.w2.bias", "mlp.w3.weight", "mlp.w3.bias",
        "head.weight", "head.bias")}
    init["attn.q_proj.weight"] = init["attn.k_proj.weight"] = [0.0, 0.3]
    for ln in ("norm1", "norm2", "attn.inner_attn_ln", "mlp.ffn_ln", "norm"):
        init[ln + ".weight"], init[ln + ".bias"] = [1.0, 0.2], [0.0, 0.1]
    return {"vision": vision, "init": init, "n_classes": 7}


def weights(arch, seed=3):
    return weights_eva.make_weights(tower_config(arch), seed, "cpu")


def images(arch, n=4, seed=0):
    s = clip_arch_config(arch).vision.image_size
    return torch.randn((n, 3, s, s), generator=torch.Generator().manual_seed(
        seed))


def rel(a, b):
    return float((a - b).norm() / b.norm())


@torch.no_grad()
def port_and_reference(arch, dtype=torch.float32, rnd=eva02.exact):
    w, _ = weights(arch)
    clip = weights_eva.port_clip(w, clip_arch_config(arch), "cpu")
    x = images(arch)
    return (encode_image(clip.visual, x, dtype=dtype),
            eva02.encode(x, w, tower_config(arch)["vision"], rnd))


def test_published_arches():
    for arch, image in (("EVA02-CLIP-L-14-336", 336), ("EVA02-CLIP-L-14",
                                                       224)):
        cfg = clip_arch_config(arch)
        v = cfg.vision
        assert (v.image_size, v.patch_size, v.width, v.layers, v.heads,
                v.output_dim) == (image, 14, 1024, 24, 16, 768)
        assert (v.mlp_hidden, v.mlp_stored, v.eps) == (2730, 2736, 1e-6)
        assert (v.rope_theta, v.pt_hw_seq_len) == (10000.0, 16)
        assert (cfg.text.width, cfg.text.heads, cfg.text.layers,
                cfg.text.act) == (768, 12, 12, "gelu")
    assert clip_arch_config("EVA02-CLIP-L-14-336").vision.seq_len == 577
    # the JAX package's table stays as it is; OpenAI's towers quick-GELU
    assert not set(EVA_ARCHS) & set(CLIP_ARCHS)
    assert {c.text.act for c in CLIP_ARCHS.values()} == {"quick_gelu"}
    for arch in DEBUG:
        v = clip_arch_config(arch).vision
        assert v.mlp_hidden % 8 and v.mlp_stored == v.mlp_hidden + 6
    assert clip_arch_config(DEBUG[0]).vision.grid != 4


@pytest.mark.parametrize("arch", DEBUG)
def test_f32_tower_matches_the_reference(arch):
    got, want = port_and_reference(arch)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert rel(got, want) < 1e-5


@pytest.mark.parametrize("arch", DEBUG)
def test_bf16_tower_matches_the_bf16_storage_reference(arch):
    got, emu = port_and_reference(arch, torch.bfloat16, eva02.to_bf16)
    _, want = port_and_reference(arch)
    # the same storage: as far from float32 as the reference rounded at
    # the same points (the sharp debug attention makes that 3-5%), and no
    # farther from that reference
    assert rel(got, want) < 1.25 * rel(emu, want)
    assert rel(got, emu) < 1.25 * rel(emu, want)


def test_rope_tables_equal_the_references():
    for grid, dh, pt in ((24, 64, 16), (6, 32, 4), (6, 32, 6), (16, 64, 16)):
        got = rope_tables(grid, dh, 10000.0, pt)
        want = eva02.rope_tables(grid, dh, 10000.0, pt)
        for g, w in zip(got, want):
            assert g.shape == (grid * grid, dh) and torch.equal(g, w)


def closed_form(qkv, heads, grid, pt, theta=10000.0):
    """The rotation written out pair by pair from the angles: a head's
    pair j < dh/4 turns by t_row theta^(-4j/dh), pair j >= dh/4 by t_col
    at the frequency of j - dh/4."""
    B, S, D3 = qkv.shape
    D = D3 // 3
    dh = D // heads
    out = qkv.double().clone()
    t = np.arange(grid) / grid * pt
    for p in range(S - 1):
        r, c = divmod(p, grid)
        for j in range(dh // 2):
            axis, k = (t[r], j) if j < dh // 4 else (t[c], j - dh // 4)
            ang = axis * theta ** (-2.0 * k / (dh // 2))
            for part in (0, 1):
                for h in range(heads):
                    at = part * D + h * dh + 2 * j
                    x0 = qkv[:, p + 1, at].double()
                    x1 = qkv[:, p + 1, at + 1].double()
                    out[:, p + 1, at] = x0 * np.cos(ang) - x1 * np.sin(ang)
                    out[:, p + 1, at + 1] = x1 * np.cos(ang) + x0 * np.sin(
                        ang)
    return out


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 8e-3)])
def test_rope_op_is_the_closed_form_rotation(dtype, tol):
    heads, dh, grid, pt = 2, 32, 3, 4
    qkv = torch.randn((2, grid * grid + 1, 3 * heads * dh),
                      generator=torch.Generator().manual_seed(1)).to(dtype)
    want = closed_form(qkv, heads, grid, pt)
    got = qkv.clone()
    rope_qkv(got, *rope_tables(grid, dh, 10000.0, pt), heads)
    D = heads * dh
    assert torch.equal(got[:, 0], qkv[:, 0])  # the class token
    assert torch.equal(got[..., 2 * D:], qkv[..., 2 * D:])  # v
    err = (got.double() - want).abs().max() / want.abs().max()
    assert err < tol
    assert not torch.equal(got[:, 2:, :2 * D], qkv[:, 2:, :2 * D])


def test_rope_op_passes_opcheck():
    qkv = torch.randn((3, 10, 192)).bfloat16()
    cos, sin = rope_tables(3, 32, 10000.0, 4)
    res = opcheck(torch.ops.eventclip.rope_qkv.default, (qkv, cos, sin, 2))
    assert set(res.values()) == {"SUCCESS"}, res


def test_rope_op_refuses_bad_arguments():
    cos, sin = rope_tables(3, 32, 10000.0, 4)
    with pytest.raises(ValueError, match="head dim"):
        rope_qkv(torch.zeros((1, 10, 3 * 36)), *rope_tables(3, 12, 1e4, 4),
                 3)
    with pytest.raises(ValueError, match="tables"):
        rope_qkv(torch.zeros((1, 10, 192)), cos[:4], sin, 2)
    with pytest.raises(ValueError, match="contiguous"):
        rope_qkv(torch.zeros((1, 192, 10)).transpose(1, 2), cos, sin, 2)


def _block(arch):
    cfg = clip_arch_config(arch).vision
    blk = EVABlock(cfg)
    gen = torch.Generator().manual_seed(2)
    with torch.no_grad():
        for p in blk.parameters():
            p.copy_(torch.randn(p.shape, generator=gen))
        eva.pad_hidden_(blk, cfg.mlp_hidden)
    return cfg, blk


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_padded_swiglu_equals_the_unpadded_one(dtype):
    cfg, blk = _block(DEBUG[0])
    H, Hs, D = cfg.mlp_hidden, cfg.mlp_stored, cfg.width
    x = torch.randn((2, 5, D)).to(dtype)
    with torch.no_grad():
        h12 = eva.dense(x, blk.w12, blk.b12)
        got = swiglu(h12, blk.ffn_ln)
        out = eva.mlp(blk, x)
        # the unpadded MLP: W1, W2 of H rows, W3 of H columns
        w1, w2 = blk.w12[:H], blk.w12[Hs:Hs + H]
        b1, b2 = blk.b12[:H], blk.b12[Hs:Hs + H]
        g = eva.dense(x, w1, b1).float()
        v = eva.dense(x, w2, b2).float()
        h = eva.layer_norm((torch.nn.functional.silu(g) * v).to(dtype),
                           blk.ffn_ln)
        want = eva.dense(h, blk.w3[:, :H], blk.b3)
    assert got.shape[-1] == Hs and torch.equal(got[..., :H], h)
    assert torch.equal(got[..., H:], torch.zeros_like(got[..., H:]))
    if dtype == torch.float32:
        assert rel(out, want) < 1e-6
    else:
        assert torch.equal(out, want)


def test_ffn_ln_takes_its_statistics_over_the_real_columns_only():
    cfg, blk = _block(DEBUG[0])
    H, Hs = cfg.mlp_hidden, cfg.mlp_stored
    assert blk.ffn_ln.normalized_shape == (H,)
    full = EVABlock(clip_arch_config("EVA02-CLIP-L-14-336").vision,
                    device="meta")
    assert full.ffn_ln.normalized_shape == (2730,)
    assert tuple(full.w12.shape) == (2 * 2736, 1024)
    assert tuple(full.w3.shape) == (1024, 2736)
    h12 = torch.randn((3, 2 * Hs))
    junk = h12.clone()
    junk[:, H:Hs] = 1e4  # whatever the pad columns hold
    junk[:, Hs + H:] = -1e4
    with torch.no_grad():
        got = swiglu(junk, blk.ffn_ln)
        h = torch.nn.functional.silu(h12[:, :H]) * h12[:, Hs:Hs + H]
        mu, var = h.mean(-1, keepdim=True), h.var(-1, False, keepdim=True)
        want = (h - mu) / torch.sqrt(var + cfg.eps) * blk.ffn_ln.weight \
            + blk.ffn_ln.bias
    assert torch.allclose(got[:, :H], want, atol=1e-5, rtol=1e-5)
    assert torch.equal(got, swiglu(h12, blk.ffn_ln))


def _openai_text(text):
    """The port's text tower in OpenAI's names (the reference's layout)."""
    sd = {"token_embedding.weight": text.token_embedding,
          "positional_embedding": text.positional_embedding,
          "ln_final.weight": text.ln_final.weight,
          "ln_final.bias": text.ln_final.bias,
          "text_projection": text.projection}
    for i, b in enumerate(text.blocks.layers):
        p = f"transformer.resblocks.{i}."
        sd.update({
            p + "ln_1.weight": b.ln_1.weight, p + "ln_1.bias": b.ln_1.bias,
            p + "attn.in_proj_weight": b.attn.wqkv,
            p + "attn.in_proj_bias": b.attn.bqkv,
            p + "attn.out_proj.weight": b.attn.wo,
            p + "attn.out_proj.bias": b.attn.bo,
            p + "ln_2.weight": b.ln_2.weight, p + "ln_2.bias": b.ln_2.bias,
            p + "mlp.c_fc.weight": b.mlp.w1, p + "mlp.c_fc.bias": b.mlp.b1,
            p + "mlp.c_proj.weight": b.mlp.w2, p + "mlp.c_proj.bias": b.mlp.b2})
    return {k: v.detach() for k, v in sd.items()}


@torch.no_grad()
def test_text_tower_takes_exact_gelu():
    cfg = clip_arch_config(DEBUG[0])
    clip = init_clip_params(cfg, torch.Generator().manual_seed(4))
    gen = torch.Generator().manual_seed(5)
    for name, p in clip.text.named_parameters():
        p.add_(0.3 * torch.randn(p.shape, generator=gen))
    tokens = torch.randint(1, 400, (3, 77), generator=gen)
    tokens[:, 9] = 49407  # the EOT
    tokens[:, 10:] = 0
    got = encode_text(clip.text, tokens)
    want = eva02.encode_text(tokens, _openai_text(clip.text),
                             cfg.text.heads)
    assert rel(got, want) < 1e-5
    # the same weights through OpenAI's quick-GELU answer otherwise
    quick = CLIP(dataclasses.replace(cfg, text=CLIP_ARCHS["ViT-T/8@32"].text))
    quick.text.load_state_dict(clip.text.state_dict())
    assert rel(encode_text(quick.text, tokens), want) > 1e-3


def _eva_state_dict(arch, seed=6):
    """A state dict in EVA-CLIP's names, `visual.` prefix, its rotary
    buffers and all, as a checkpoint holds it."""
    w, _ = weights(arch, seed)
    sd = {"visual." + k: v for k, v in w.items()}
    for where in ("visual.rope.", "visual.blocks.0.attn.rope."):
        sd[where + "freqs_cos"] = torch.zeros((36, 32))
        sd[where + "freqs_sin"] = torch.zeros((36, 32))
    return w, sd


def test_eva_key_map():
    arch = DEBUG[0]
    cfg = clip_arch_config(arch).vision
    H, Hs, D = cfg.mlp_hidden, cfg.mlp_stored, cfg.width
    w, sd = _eva_state_dict(arch)
    tower = init_clip_params(clip_arch_config(arch),
                             torch.Generator().manual_seed(0)).visual
    load_eva_visual_(tower, sd)
    b = tower.blocks[1]
    p = "blocks.1."
    assert torch.equal(b.wqkv, torch.cat([w[p + f"attn.{t}_proj.weight"]
                                          for t in "qkv"]))
    assert torch.equal(b.bqkv[:D], w[p + "attn.q_bias"])
    assert torch.equal(b.bqkv[D:2 * D], torch.zeros(D))
    assert torch.equal(b.bqkv[2 * D:], w[p + "attn.v_bias"])
    assert torch.equal(b.w12[:H], w[p + "mlp.w1.weight"])
    assert torch.equal(b.w12[Hs:Hs + H], w[p + "mlp.w2.weight"])
    assert torch.equal(b.b12[Hs:Hs + H], w[p + "mlp.w2.bias"])
    for t in (b.w12[H:Hs], b.w12[Hs + H:], b.b12[H:Hs], b.b12[Hs + H:],
              b.w3[:, H:]):
        assert not t.any()
    assert torch.equal(b.w3[:, :H], w[p + "mlp.w3.weight"])
    assert torch.equal(b.ffn_ln.weight, w[p + "mlp.ffn_ln.weight"])
    assert torch.equal(b.inner_attn_ln.bias,
                       w[p + "attn.inner_attn_ln.bias"])
    assert torch.equal(tower.patch_embed,
                       w["patch_embed.proj.weight"].reshape(D, -1))
    assert torch.equal(tower.head_bias, w["head.bias"])
    assert torch.equal(tower.class_embedding, w["cls_token"].reshape(D))
    # a name the map does not know, or a missing one, raises
    with pytest.raises(KeyError, match="does not map"):
        eva_visual_state_dict(dict(sd, **{"visual.fc_norm.weight":
                                          torch.ones(D)}), cfg)
    del sd["visual.blocks.0.mlp.w3.bias"]
    with pytest.raises(KeyError):
        eva_visual_state_dict(sd, cfg)


@pytest.mark.parametrize("fault", sorted(faults_eva.FAULTS))
def test_each_fault_fails_the_f32_comparison(fault, monkeypatch):
    faults_eva.FAULTS[fault](monkeypatch.setattr)
    got, want = port_and_reference(DEBUG[0])
    assert rel(got, want) > 1e-3


def _predictor(arch, **kw):
    w, text = weights(arch)
    # a smaller head spreads the probabilities (logits of about 2)
    for k in ("head.weight", "head.bias"):
        w[k] = w[k] * 0.02
    clip = weights_eva.port_clip(w, clip_arch_config(arch), "cpu")
    params = Params(model="ZSCLIP", dataset="n_caltech", bf16=False,
                    quantize_args={"max_imgs": 2, "N": 20000,
                                   "split_method": "event_count",
                                   "convert_method": "event_histogram",
                                   "grayscale": True,
                                   "count_non_zero": False,
                                   "background_mask": True},
                    clip_dict={"arch": arch, "agg_func": "mean",
                               "prompt": "a point cloud image of a {}"})
    names = [f"c{i}" for i in range(len(text))]
    return Predictor(params, names, clip_params=clip, text_feats=text,
                     batch_size=4, device="cpu", **kw), w, text


def test_predictor_serves_the_debug_tower_end_to_end():
    arch = DEBUG[0]
    pred, w, text = _predictor(arch)
    rng = np.random.default_rng(0)
    spec = {"duration_s": 0.3, "noise": 0.2, "blob_sigma": [0.05, 0.15],
            "drift": [0.0, 0.5]}
    batch = [streams.blob_stream(rng, n, 180, 240, spec)
             for n in (15000, 30000, 45000, 61000, 90000)]
    out = pred.predict(batch)
    geo = {"height": 180, "width": 240, "window": 20000, "views": 10,
           "image_size": 48, "logit_scale": 100.0, "thresh": 10.0,
           "grey": 127.0, "tower": tower_config(arch)["vision"]}
    want = eva02.stream_probs(batch, w, text, geo)
    got = np.asarray(out["probs"])
    assert got.shape == want.shape == (5, 7)
    assert np.abs(got - want).max() < 1e-5
    assert np.abs(want - np.roll(want, 1, axis=0)).max() > 1e-2


def test_refusals():
    arch = DEBUG[0]
    with pytest.raises(ValueError, match="token pruning"):
        _predictor(arch, prune_tokens=8)
    with pytest.raises(ValueError, match="int8"):
        _predictor(arch, int8=True)
    cfg = clip_arch_config(arch)
    clip = init_clip_params(cfg, torch.Generator().manual_seed(0))
    x = images(arch, 2)
    with torch.no_grad():
        for kw, what in ((dict(tp=object()), "tensor parallelism"),
                         (dict(lora={}), "LoRA"), (dict(remat=True), "remat"),
                         (dict(keep_tokens=8), "token pruning")):
            with pytest.raises(ValueError, match=what):
                encode_image(clip.visual, x, **kw)
    with pytest.raises(ValueError, match="training"):
        encode_image(clip.visual, x)  # a gradient is being recorded
    params = Params(model="FTCLIP", clip_dict={"arch": arch}, bf16=False)
    cls_cfg = build_classifier_config(params, cfg)
    cls_params = init_classifier_params(cls_cfg, torch.Generator()
                                        .manual_seed(0), clip=clip,
                                        n_classes=3)
    with pytest.raises(ValueError, match="training"):
        classifier_forward(cls_params, cls_cfg, x[:, None],
                           torch.ones((2, 1), dtype=bool), train=True)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run on the card only)")
    return torch.device("cuda")


@pytest.mark.parametrize("B,S,heads,dh", [(320, 577, 16, 64), (3, 37, 2, 32),
                                          (5, 10, 4, 8), (2, 2, 16, 64)])
def test_rope_kernel_equals_the_plain_version_on_card(cuda, B, S, heads,
                                                      dh):
    from eventclip_tpu_torch.ops.rope import rope_qkv_plain

    g = int((S - 1) ** 0.5)
    gen = torch.Generator().manual_seed(S)
    qkv = (4 * torch.randn((B, S, 3 * heads * dh), generator=gen)).bfloat16()
    if g * g == S - 1:
        cos, sin = rope_tables(g, dh, 10000.0, 16)
    else:
        cos, sin = (torch.randn((S - 1, dh), generator=gen)
                    for _ in range(2))
    want = qkv.clone()
    rope_qkv_plain(want, cos, sin, heads)
    got = qkv.to(cuda)
    kernels.reset_launches()
    rope_qkv(got, cos.to(cuda), sin.to(cuda), heads)
    torch.cuda.synchronize()
    assert dict(kernels.LAUNCHES) == {"rope_qkv": 1}
    assert torch.equal(got.cpu(), want)


@torch.no_grad()
def test_tower_launches_the_kernels_on_card(cuda):
    arch = DEBUG[0]
    w, _ = weights(arch)
    clip = weights_eva.port_clip({k: v.to(cuda) for k, v in w.items()},
                                 clip_arch_config(arch), cuda)
    x = images(arch)
    kernels.reset_launches()
    got = encode_image(clip.visual, x.to(cuda), dtype=torch.bfloat16).cpu()
    torch.cuda.synchronize()
    L = clip_arch_config(arch).vision.layers
    # 4 products a block, and the patch embedding: K = 3 x 8 x 8 = 192 is
    # a multiple of 8 at the debug tower (at L/14, K = 588 is not)
    assert dict(kernels.LAUNCHES) == {"rope_qkv": L, "qkv_attention": L,
                                      "dense": 4 * L + 1, "swiglu_ln": L}
    emu = eva02.encode(x, w, tower_config(arch)["vision"], eva02.to_bf16)
    want = eva02.encode(x, w, tower_config(arch)["vision"])
    assert rel(got, want) < 2 * rel(emu, want)
