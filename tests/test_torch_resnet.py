"""The port's ResNet CLIP towers (models/clip/resnet.py) equal the JAX
package's.

- The towers, at the debug arch RN-T@32 and at the (1, 2, 1, 1) width-16
  oracle of tests/test_resnet.py, built from the same JAX tree
  (`init_clip_params`, or the oracle's state dict through the JAX
  converter), give the JAX `encode_image_resnet` features in f32 within
  rtol 2e-4, atol 2e-5, and in bf16 within one bf16 rounding of the
  largest feature (both round in the same order: the weight cast to the
  activation dtype, f32 accumulation, the affine's two roundings).
- The tower's leaves cross to the JAX tree and back unchanged, and
  chip_smoke's OpenAI-layout export (drawn batch-norm statistics) folds
  back to the tower.
- The classifier heads run on a ResNet tower as the JAX package's (ZS and
  FS probabilities, f32 tolerance); `keep_tokens` is ignored; LoRA on a
  ResNet is refused in both packages at init (TypeError); int8 is refused
  with the JAX package's ValueError; `build_model` builds ZS and FS heads.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from eventclip_tpu.models import classifier as ref_classifier
from eventclip_tpu.models.clip import convert as ref_convert
from eventclip_tpu.models.clip import model as ref_model
from eventclip_tpu.models.clip import resnet as ref_resnet
from eventclip_tpu.models.clip.config import clip_arch_config as ref_arch
from eventclip_tpu.ops import quant as ref_quant
from eventclip_tpu_torch.models import classifier, factory
from eventclip_tpu_torch.models.clip import convert, model, resnet
from eventclip_tpu_torch.models.clip.config import (ResNetVisionConfig,
                                                     clip_arch_config)
from eventclip_tpu_torch.ops import quant
from eventclip_tpu_torch.utils.config import load_params

from .test_resnet import ModifiedResNetOracle, oracle_state_dict

ARCH = "RN-T@32"
RTOL, ATOL = 2e-4, 2e-5


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _oracle_tree():
    """tests/test_resnet.py's oracle (random BN statistics) through the JAX
    converter: (its CLIP tree, config)."""
    torch.manual_seed(0)
    m = ModifiedResNetOracle(layers=(1, 2, 1, 1), width=16, image_size=64,
                             heads=8, output_dim=32).eval()
    with torch.no_grad():
        for mod in m.modules():
            if isinstance(mod, torch.nn.BatchNorm2d):
                mod.running_mean.normal_(0.0, 0.2)
                mod.running_var.uniform_(0.5, 1.5)
                mod.weight.uniform_(0.5, 1.5)
                mod.bias.normal_(0.0, 0.1)
    sd = oracle_state_dict(m)
    return (_np_tree(ref_convert.convert_clip_state_dict(sd)),
            ref_convert.infer_config_from_state_dict(sd))


@pytest.fixture(scope="module")
def rn_tree():
    """The JAX package's random RN-T@32 CLIP tree (jitted init)."""
    init = jax.jit(ref_model.init_clip_params, static_argnums=1)
    return _np_tree(init(jax.random.PRNGKey(3), ref_arch(ARCH)))


@pytest.fixture(scope="module", params=["RN-T@32", "oracle"])
def towers(request, rn_tree):
    """(JAX tree, JAX config, port CLIP) from the same parameters."""
    if request.param == "oracle":
        tree, ref_cfg = _oracle_tree()
        cfg = convert.infer_config_from_state_dict(oracle_state_dict(
            ModifiedResNetOracle((1, 2, 1, 1), 16, 64, 8, 32)))
    else:
        tree, ref_cfg, cfg = rn_tree, ref_arch(ARCH), clip_arch_config(ARCH)
    return tree, ref_cfg, convert.clip_from_jax(tree, cfg, device="cpu")


_ref_encode = jax.jit(ref_resnet.encode_image_resnet, static_argnums=1,
                      static_argnames="dtype")


def test_tower_matches_jax_f32_and_bf16(towers):
    tree, ref_cfg, clip = towers
    S = ref_cfg.vision.image_size
    x = np.random.default_rng(1).normal(size=(3, 3, S, S)).astype(np.float32)
    visual = jax.tree_util.tree_map(jnp.asarray, tree["visual"])
    for dtype, jdtype in ((torch.float32, jnp.float32),
                          (torch.bfloat16, jnp.bfloat16)):
        want = np.asarray(_ref_encode(visual, ref_cfg.vision,
                                      jnp.asarray(x), dtype=jdtype))
        with torch.no_grad():
            got = resnet.encode_image_resnet(clip.visual,
                                             torch.from_numpy(x), dtype=dtype)
        assert got.dtype == torch.float32 and got.shape == want.shape
        if dtype == torch.float32:
            np.testing.assert_allclose(got.numpy(), want, rtol=RTOL,
                                       atol=ATOL)
        else:
            np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                       atol=2 ** -8 * np.abs(want).max())


def test_leaves_round_trip_to_the_jax_tree(towers):
    tree, _, clip = towers
    got = convert.to_jax_flat(clip.named_parameters())
    want = convert.flatten_tree(tree)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert convert.jax_shapes(clip.named_parameters()) == {
        k: v.shape for k, v in want.items()}
    # the stacked `rest` blocks and the folded batch norms by name
    assert convert.jax_path("clip.visual.layer2.rest.layers.0.bn3.weight") \
        == ("clip/visual/layer2/rest/bn3/scale", 0)
    assert convert.jax_path("clip.visual.layer1.block0.downsample.conv") \
        == ("clip/visual/layer1/block0/downsample/conv", None)


def test_openai_export_folds_back():
    clip = model.init_clip_params(clip_arch_config(ARCH),
                                  torch.Generator().manual_seed(2))
    sd = chip_smoke.openai_state_dict(clip)
    assert sd["visual.layer1.0.bn1.running_var"].min() >= 0.5
    assert "visual.layer1.0.downsample.0.weight" in sd
    cfg = convert.infer_config_from_state_dict(sd)
    assert isinstance(cfg.vision, ResNetVisionConfig)
    assert cfg.vision.layers == (1, 1, 1, 1) and cfg.name == "RN-w8"
    back = convert.clip_from_jax(convert.convert_clip_state_dict(sd),
                                 clip_arch_config(ARCH), device="cpu")
    for (name, a), (_, b) in zip(clip.named_parameters(),
                                 back.named_parameters()):
        np.testing.assert_allclose(b.detach().numpy(), a.detach().numpy(),
                                   rtol=1e-6, atol=1e-7, err_msg=name)


@pytest.mark.parametrize("kind", ["ZSCLIP", "FSCLIP"])
def test_classifier_heads_on_resnet_match_jax(kind, rn_tree):
    """ZS and FS heads over an RN-T@32 tower: the same probabilities as
    the JAX classifier (FS: the JAX adapter's weights crossed over, its
    dropout off); keep_tokens changes nothing on a ResNet."""
    params_cfg = load_params("configs/debug/fsclip_tiny_params.py")
    params_cfg.model = kind
    params_cfg.clip_dict["arch"] = ARCH
    if kind == "ZSCLIP":
        params_cfg.adapter_dict = {}
    ref_cfg = ref_classifier.build_classifier_config(params_cfg,
                                                     ref_arch(ARCH))
    ref_params = _np_tree(ref_classifier.init_classifier_params(
        jax.random.PRNGKey(4), ref_cfg, clip_params=rn_tree, n_classes=5))
    cfg = classifier.build_classifier_config(params_cfg,
                                             clip_arch_config(ARCH))
    params = classifier.init_classifier_params(
        cfg, torch.Generator().manual_seed(0), n_classes=5)
    params.load_state_dict(convert.from_jax_params(ref_params))
    imgs = np.random.default_rng(5).normal(
        size=(2, 3, 3, 32, 32)).astype(np.float32)
    valid = np.array([[1, 1, 0], [1, 0, 0]], bool)
    want = jax.jit(ref_classifier.classifier_forward, static_argnums=1)(
        jax.tree_util.tree_map(jnp.asarray, ref_params), ref_cfg,
        jnp.asarray(imgs), jnp.asarray(valid))
    with torch.inference_mode():
        got = classifier.classifier_forward(
            params, cfg, torch.from_numpy(imgs), torch.from_numpy(valid))
        pruned = classifier.classifier_forward(
            params, dataclasses.replace(cfg, keep_tokens=1),
            torch.from_numpy(imgs), torch.from_numpy(valid))
    for key in ("probs", "view_feats"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=RTOL, atol=ATOL, err_msg=key)
    assert torch.equal(pruned["probs"], got["probs"])


def test_lora_and_int8_on_resnet_are_refused_like_jax(rn_tree):
    rn = clip_arch_config(ARCH)
    cfg = classifier.ClassifierConfig(model="FTCLIP", clip=rn, lora=4,
                                      ft_mode="lora")
    with pytest.raises(TypeError, match="LoRA targets the ViT attention"):
        classifier.init_classifier_params(
            cfg, torch.Generator().manual_seed(0), n_classes=3)
    ref_cfg = ref_classifier.ClassifierConfig(model="FTCLIP",
                                              clip=ref_arch(ARCH), lora=4,
                                              ft_mode="lora")
    with pytest.raises(TypeError):
        ref_classifier.init_classifier_params(
            jax.random.PRNGKey(0), ref_cfg, clip_params=rn_tree, n_classes=3)
    zs = classifier.ClassifierConfig(model="ZSCLIP", clip=rn)
    params = classifier.init_classifier_params(
        zs, torch.Generator().manual_seed(0), n_classes=3)
    ref_params = ref_classifier.init_classifier_params(
        jax.random.PRNGKey(0), dataclasses.replace(ref_cfg, model="ZSCLIP",
                                                   lora=None,
                                                   ft_mode="full"),
        clip_params=rn_tree, n_classes=3)
    with pytest.raises(ValueError, match="ViT towers only") as got:
        quant.quantize_classifier_params(params)
    with pytest.raises(ValueError, match="ViT towers only") as want:
        ref_quant.quantize_classifier_params(ref_params)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="ViT towers only"):
        quant.calibrate_visual_amax(params.clip.visual,
                                    torch.zeros(1, 3, 32, 32))


@pytest.mark.parametrize("config", ["zsclip_tiny_params.py",
                                    "fsclip_tiny_params.py"])
def test_build_model_on_resnet(config):
    p = load_params(f"configs/debug/{config}")
    p.clip_dict["arch"] = ARCH
    m = factory.build_model(p, ["a", "b", "c"], dtype=torch.float32,
                            device="cpu")
    out = m({"img": torch.randn(2, 2, 3, 32, 32),
             "valid_mask": torch.ones(2, 2, dtype=torch.bool)})
    assert out["probs"].shape == (2, 3)
    assert torch.isfinite(out["probs"]).all()
    assert isinstance(m.params.clip.visual, resnet.ResNetVisionTower)


def test_f32_tower_turns_tf32_off_only_while_it_runs(monkeypatch):
    """The f32 ResNet forward on the card runs with cuDNN's and cuBLAS's
    TF32 off whatever the process set, and gives the settings back."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    seen = []
    with resnet._ieee_f32(True):
        seen.append((torch.backends.cudnn.allow_tf32,
                     torch.backends.cuda.matmul.allow_tf32))
    assert seen == [(False, False)]
    assert torch.backends.cudnn.allow_tf32
    assert torch.backends.cuda.matmul.allow_tf32


def test_out_of_vocab_ids_raise_where_jax_clamps(rn_tree):
    """RN-T@32's text tower has 128 ids: a BPE id beyond them makes the
    port's embedding lookup raise, where the JAX gather clamps to the last
    row (a difference by design; real archs have all 49408 ids)."""
    clip = convert.clip_from_jax(rn_tree, clip_arch_config(ARCH),
                                 device="cpu")
    toks = np.zeros((1, 16), np.int64)
    toks[0, :3] = [5, 200, 127]
    out = ref_model.encode_text(jax.tree_util.tree_map(jnp.asarray,
                                                       rn_tree["text"]),
                                ref_arch(ARCH).text, jnp.asarray(toks))
    assert np.isfinite(np.asarray(out)).all()
    with pytest.raises(IndexError):
        model.encode_text(clip.text, torch.from_numpy(toks))
