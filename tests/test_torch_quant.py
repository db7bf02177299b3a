"""The port's W8A8 int8 path (ops/quant.py) vs the JAX package's.

Same weights and inputs (numpy, from a seed) through both packages, the
JAX functions jitted as the serving path runs them. Tolerances, and why:

- codes: equal, except at most 1 apart at a share under 1e-3 (XLA may
  evaluate `w / s` as `w * rcp(s)`, which moves a value sitting on a .5
  boundary by one quantum); scales to rtol 1e-6 (one ulp);
- `qdense` in f32: max |port - JAX| <= 1e-5 * max |JAX| (the int32 sums
  are exact; what differs is a rare one-quantum activation code and the
  f32 rescale's rounding);
- the int8 `encode_image` in f32: ||port - JAX|| / ||JAX|| <= 1e-4 (the
  few code flips above, carried through two layers);
- calibration maxima in f32 to rtol 1e-6, as tests/test_quant.py holds
  the JAX package to itself; predictions equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eventclip_tpu.models import classifier as ref_cls
from eventclip_tpu.models.clip import model as ref_model
from eventclip_tpu.models.clip.config import clip_arch_config as ref_arch
from eventclip_tpu.ops import quant as ref_quant
from eventclip_tpu_torch.models import classifier
from eventclip_tpu_torch.models.clip import model
from eventclip_tpu_torch.models.clip.config import clip_arch_config
from eventclip_tpu_torch.models.clip.convert import clip_from_jax
from eventclip_tpu_torch.ops import quant

ARCH = "ViT-T/8@32"


def _codes_match(got: np.ndarray, want: np.ndarray) -> None:
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert diff.max() <= 1, diff.max()
    assert (diff > 0).mean() < 1e-3, (diff > 0).mean()


@pytest.mark.parametrize("shape", [(256, 588), (2, 3, 16, 32)],
                         ids=["patch_embed", "stacked"])
def test_quantize_weight_matches_jax(shape):
    w = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    want = jax.jit(ref_quant.quantize_weight)(jnp.asarray(w))
    got = quant.quantize_weight(torch.from_numpy(w))
    assert got.q.dtype == torch.int8 and got.s.shape == shape[:-1]
    _codes_match(got.q.numpy(), np.asarray(want["q"]))
    np.testing.assert_allclose(got.s.numpy(), np.asarray(want["s"]),
                               rtol=1e-6, atol=0)


@pytest.mark.parametrize("static", [False, True], ids=["dynamic", "static"])
@pytest.mark.parametrize("K", [588, 64], ids=["K588", "K64"])
def test_qdense_matches_jax(static, K):
    rng = np.random.default_rng(K + static)
    x = rng.normal(size=(5, 7, K)).astype(np.float32)
    w = rng.normal(size=(48, K)).astype(np.float32)
    b = rng.normal(size=(48,)).astype(np.float32)
    qw = ref_quant.quantize_weight(jnp.asarray(w))
    pw = quant.quantize_weight(torch.from_numpy(w))
    if static:  # a scale that clips the largest activations
        a = np.float32(0.6 * np.abs(x).max() / 127.0)
        qw = {**qw, "a": jnp.asarray(a)}
        pw = quant.QWeight(pw.q, pw.s, torch.tensor(a))
    want = np.asarray(jax.jit(ref_quant.qdense)(jnp.asarray(x), qw,
                                                jnp.asarray(b)))
    got = quant.qdense(torch.from_numpy(x), pw, torch.from_numpy(b)).numpy()
    assert got.shape == (5, 7, 48) and got.dtype == np.float32
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("M,K,N", [(3, 588, 48), (40, 588, 1024),
                                   (17, 64, 20)])
def test_int_mm_padding_is_exact(M, K, N):
    """K to a multiple of 8 (ViT-L/14's patch_embed: 588 -> 592), M past
    16 and N to a multiple of 8: the padded product equals the int32
    product of the operands as given."""
    gen = torch.Generator().manual_seed(M)
    a = torch.randint(-127, 128, (M, K), generator=gen, dtype=torch.int8)
    w = torch.randint(-127, 128, (N, K), generator=gen, dtype=torch.int8)
    got = quant._int_mm(a, w.t())
    assert got.dtype == torch.int32 and got.shape == (M, N)
    assert torch.equal(got, a.int() @ w.int().t())


@pytest.fixture(scope="module")
def towers():
    cfg = ref_arch(ARCH)
    tree = jax.tree_util.tree_map(
        np.asarray, ref_model.init_clip_params(jax.random.PRNGKey(3), cfg))
    return cfg, tree, clip_from_jax(tree, clip_arch_config(ARCH), "cpu")


def _images(seed, n=4):
    return np.random.default_rng(seed).normal(
        size=(n, 3, 32, 32)).astype(np.float32)


def test_calibrate_visual_amax_matches_jax(towers):
    cfg, tree, clip = towers
    imgs = _images(1)
    want = ref_quant.calibrate_visual_amax(
        jax.tree_util.tree_map(jnp.asarray, tree["visual"]), cfg.vision,
        jnp.asarray(imgs), dtype=jnp.float32)
    got = quant.calibrate_visual_amax(clip.visual, torch.from_numpy(imgs),
                                      dtype=torch.float32)
    assert got.shape == (cfg.vision.layers, 4) and (got > 0).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


@pytest.mark.parametrize("calibrated", [False, True],
                         ids=["dynamic", "static"])
def test_int8_encode_image_matches_jax(towers, calibrated):
    cfg, tree, clip = towers
    imgs = _images(2)
    ref_visual = jax.tree_util.tree_map(jnp.asarray, tree["visual"])
    amax = None
    if calibrated:
        amax = np.asarray(ref_quant.calibrate_visual_amax(
            ref_visual, cfg.vision, jnp.asarray(_images(3)),
            dtype=jnp.float32))
    qref = ref_quant.quantize_visual(
        ref_visual, act_amax=None if amax is None else jnp.asarray(amax))
    want = np.asarray(jax.jit(
        lambda v, x: ref_model.encode_image(v, cfg.vision, x))(
            qref, jnp.asarray(imgs)))
    qport = quant.quantize_visual(
        clip.visual, act_amax=None if amax is None else torch.tensor(amax))
    with torch.no_grad():
        got = model.encode_image(qport, torch.from_numpy(imgs)).numpy()
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel <= 1e-4, rel
    # and it is a quantized forward: away from the float one
    with torch.no_grad():
        full = model.encode_image(clip.visual, torch.from_numpy(imgs)).numpy()
    assert np.linalg.norm(got - full) / np.linalg.norm(full) > 1e-4


def test_quantize_visual_is_idempotent_partial_and_leaves_float(towers):
    _, _, clip = towers
    before = {k: v.clone() for k, v in clip.visual.state_dict().items()}
    qvis = quant.quantize_visual(clip.visual)
    blk = qvis.blocks.layers[0]
    for w in (qvis.patch_embed, blk.attn.wqkv, blk.attn.wo, blk.mlp.w1,
              blk.mlp.w2):
        assert isinstance(w, quant.QWeight) and w.q.dtype == torch.int8
        assert w.a is None  # dynamic until calibrated
    # float leaves untouched and shared with the float tower
    assert qvis.proj is clip.visual.proj
    assert qvis.ln_pre.weight is clip.visual.ln_pre.weight
    assert blk.attn.bqkv is clip.visual.blocks.layers[0].attn.bqkv
    # the float tower is as it was
    assert isinstance(clip.visual.patch_embed, torch.nn.Parameter)
    for k, v in clip.visual.state_dict().items():
        assert torch.equal(v, before[k]), k
    again = quant.quantize_visual(qvis)
    assert again.blocks.layers[0].attn.wqkv.q is blk.attn.wqkv.q


def test_static_scales_attach_as_amax_over_127(towers):
    cfg, _, clip = towers
    amax = quant.calibrate_visual_amax(clip.visual,
                                       torch.from_numpy(_images(4)),
                                       dtype=torch.float32)
    qvis = quant.quantize_visual(clip.visual, act_amax=amax)
    for i, blk in enumerate(qvis.blocks.layers):
        for j, (group, key) in enumerate(quant.SITES):
            a = getattr(getattr(blk, group), key).a
            torch.testing.assert_close(a, amax[i, j] / 127.0, rtol=1e-6,
                                       atol=0)
    assert qvis.patch_embed.a is None  # patch_embed stays dynamic


def test_calibration_requires_float_tower(towers):
    _, _, clip = towers
    qvis = quant.quantize_visual(clip.visual)
    with pytest.raises(AssertionError, match="FLOAT tower"):
        quant.calibrate_visual_amax(qvis, torch.from_numpy(_images(5, 2)),
                                    dtype=torch.float32)


def test_resnet_towers_are_refused_like_jax():
    class Visual:  # a ResNet tower: known by its config, as every tower
        cfg = clip_arch_config("RN-T@32").vision

    class Clip:
        visual = Visual()

    class Params:
        clip = Clip()

    with pytest.raises(ValueError, match="ViT towers only") as port_err:
        quant.quantize_classifier_params(Params())
    with pytest.raises(ValueError, match="ViT towers only") as ref_err:
        ref_quant.quantize_classifier_params({"clip": {"visual": {}}})
    assert str(port_err.value) == str(ref_err.value)


def test_quantized_classifier_matches_jax(towers):
    """ZS head over the int8 tower: probabilities to 1e-4 of the JAX int8
    head's and the same labels; the text tower and text features stay
    float, shared with the float parameters, which stay as they were."""
    cfg, tree, clip = towers
    rng = np.random.default_rng(6)
    tf = rng.normal(size=(7, cfg.embed_dim)).astype(np.float32)
    tf /= np.linalg.norm(tf, axis=-1, keepdims=True)
    imgs = rng.normal(size=(3, 2, 3, 32, 32)).astype(np.float32)
    valid = np.ones((3, 2), bool)
    ref_cfg = ref_cls.ClassifierConfig(model="ZSCLIP", clip=cfg,
                                       dtype=jnp.float32)
    ref_params = ref_quant.quantize_classifier_params(
        {"clip": jax.tree_util.tree_map(jnp.asarray, tree),
         "text_feats": jnp.asarray(tf)})
    want = np.asarray(ref_cls.classifier_forward(
        ref_params, ref_cfg, jnp.asarray(imgs), jnp.asarray(valid))["probs"])
    port_cfg = classifier.ClassifierConfig(
        model="ZSCLIP", clip=clip_arch_config(ARCH))
    params = classifier.ClassifierParams(clip, torch.from_numpy(tf))
    qparams = quant.quantize_classifier_params(params)
    assert (qparams.clip.text.token_embedding
            is params.clip.text.token_embedding)
    assert qparams.text_feats is params.text_feats
    assert isinstance(params.clip.visual.patch_embed, torch.nn.Parameter)
    with torch.no_grad():
        got = classifier.classifier_forward(
            qparams, port_cfg, torch.from_numpy(imgs),
            torch.from_numpy(valid))["probs"].numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def test_fast_path_keeps_bf16_dtype(towers):
    """In a bf16 tower the int8 product returns bf16, as JAX's does."""
    _, _, clip = towers
    qvis = quant.quantize_visual(clip.visual)
    x = torch.randn(2, 5, 64).bfloat16()
    y = model.dense(x, qvis.blocks.layers[0].attn.wqkv,
                    qvis.blocks.layers[0].attn.bqkv)
    assert y.dtype == torch.bfloat16 and y.shape == (2, 5, 192)

