"""The port's checkpoint converters equal the JAX package's.

- OpenAI CLIP state dicts (f32 and the releases' fp16, in memory and as a
  `.pt` written with torch.save), ViT and ResNet (batch norms folded, each
  stage's later blocks stacked), convert to array-equal numpy trees and
  infer the same architecture; the towers the port loads from them give
  the JAX encoders' features within the f32 tolerances of
  tests/test_torch_clip.py (rtol 2e-4, atol 2e-5).
- `resolve_clip_params` loads a `.pt` and a converted `.npz` (ViT and
  ResNet) to the JAX package's towers and refuses what the JAX package
  refuses; FS checkpoints of a ResNet classifier load both ways, and an
  FT checkpoint with a ResNet tower is refused in both packages.
- Reference method checkpoints (adapter + text_feats, an FT visual tower,
  LoRA on qkv and on qkvo) convert to equal trees in both directions, and
  a `.pth` loads into the port's ClassifierParams through load_checkpoint.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from eventclip_tpu.engine import checkpoint as ref_ckpt
from eventclip_tpu.engine import trainer as ref_trainer
from eventclip_tpu.models import classifier as ref_classifier
from eventclip_tpu.models.clip import convert as ref_convert
from eventclip_tpu.models.clip import convert_method as ref_method
from eventclip_tpu.models.clip import model as ref_model
from eventclip_tpu.models.clip.config import clip_arch_config as ref_arch
from eventclip_tpu.models.partition import trainable_mask, trainable_subtree
from eventclip_tpu.utils.config import load_params as ref_load_params
from eventclip_tpu_torch.engine import trainer
from eventclip_tpu_torch.engine.checkpoint import (load_checkpoint,
                                                   save_trainable)
from eventclip_tpu_torch.models import classifier
from eventclip_tpu_torch.models.clip import convert, convert_method, model
from eventclip_tpu_torch.models.clip.config import clip_arch_config
from eventclip_tpu_torch.utils.config import load_params

from .test_convert_method import ref_adapter_module
from .test_resnet import ModifiedResNetOracle, oracle_state_dict
from .torch_oracle import random_clip_state_dict

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "ViT-T/8@32"
# ViT-T/8@32's shapes (the debug configs' tower)
TINY = dict(width=64, layers=2, patch=8, image=32, t_width=32, t_layers=2,
            vocab=49408, context=77, embed=32)


def flat(tree):
    return convert.flatten_tree(jax.tree_util.tree_map(np.asarray, tree))


def assert_trees_equal(got, want):
    got, want = flat(got), flat(want)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.fixture(scope="module", params=["float32", "float16"])
def state_dict(request):
    sd = random_clip_state_dict(np.random.default_rng(3))
    return {k: v.to(getattr(torch, request.param)) for k, v in sd.items()}


def test_convert_clip_state_dict_equals_jax(state_dict):
    got = convert.convert_clip_state_dict(state_dict)
    assert_trees_equal(got, ref_convert.convert_clip_state_dict(state_dict))
    # every leaf is the file's value cast to f32
    np.testing.assert_array_equal(
        got["visual"]["blocks"]["mlp"]["w1"][1],
        state_dict["visual.transformer.resblocks.1.mlp.c_fc.weight"]
        .float().numpy())


def test_infer_config_equals_jax(state_dict):
    got = convert.infer_config_from_state_dict(state_dict)
    want = ref_convert.infer_config_from_state_dict(state_dict)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_load_pt_equals_jax(state_dict, tmp_path):
    path = str(tmp_path / "clip.pt")
    torch.save(state_dict, path)
    tree, cfg = convert.load_clip_checkpoint(path)
    ref_tree, ref_cfg = ref_convert.load_clip_checkpoint(path)
    assert_trees_equal(tree, ref_tree)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref_cfg)


def test_loaded_towers_match_jax_features(state_dict):
    tree = convert.convert_clip_state_dict(state_dict)
    cfg = convert.infer_config_from_state_dict(state_dict)
    ref_cfg = ref_convert.infer_config_from_state_dict(state_dict)
    clip = convert.clip_from_jax(tree, cfg, device="cpu")
    jtree = jax.tree_util.tree_map(jnp.asarray, tree)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(4, 3, 32, 32)).astype(np.float32)
    want = np.asarray(ref_model.encode_image(jtree["visual"], ref_cfg.vision,
                                             jnp.asarray(x)))
    got = model.encode_image(clip.visual, torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=2e-4,
                               atol=2e-5)
    toks = np.zeros((3, cfg.text.context_length), np.int64)
    for i in range(3):  # SOT, ids, EOT (the highest id), padding
        toks[i, 0] = cfg.text.vocab_size - 2
        toks[i, 1:3 + i] = rng.integers(1, cfg.text.vocab_size - 2, 2 + i)
        toks[i, 3 + i] = cfg.text.vocab_size - 1
    want = np.asarray(ref_model.encode_text(jtree["text"], ref_cfg.text,
                                            jnp.asarray(toks)))
    got = model.encode_text(clip.text, torch.from_numpy(toks))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=2e-4,
                               atol=2e-5)


@pytest.fixture(scope="module", params=["float32", "float16"])
def resnet_state_dict(request):
    """tests/test_resnet.py's (1, 2, 1, 1) width-16 oracle in OpenAI's
    layout, with drawn batch-norm statistics, in f32 and in fp16."""
    torch.manual_seed(0)
    m = ModifiedResNetOracle((1, 2, 1, 1), 16, 64, 8, 32).eval()
    with torch.no_grad():
        for mod in m.modules():
            if isinstance(mod, torch.nn.BatchNorm2d):
                mod.running_mean.normal_(0.0, 0.2)
                mod.running_var.uniform_(0.5, 1.5)
                mod.weight.uniform_(0.5, 1.5)
    sd = oracle_state_dict(m)
    return {k: v.to(getattr(torch, request.param))
            if v.is_floating_point() else v for k, v in sd.items()}


def test_resnet_state_dict_converts_like_jax(resnet_state_dict, tmp_path):
    """The ResNet branch: the same config, and every leaf bit-equal to
    the JAX converter's (batch norms folded by the same f32 numpy
    operations; each stage's later blocks stacked under `rest`), in
    memory and through a `.pt` on disk."""
    sd = resnet_state_dict
    got = convert.convert_clip_state_dict(sd)
    assert_trees_equal(got, ref_convert.convert_clip_state_dict(sd))
    cfg = convert.infer_config_from_state_dict(sd)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        ref_convert.infer_config_from_state_dict(sd))
    assert cfg.vision.layers == (1, 2, 1, 1) and cfg.vision.heads == 8
    assert got["visual"]["layer2"]["rest"]["conv1"].shape == (1, 32, 128,
                                                              1, 1)
    path = str(tmp_path / "rn.pt")
    torch.save(sd, path)
    tree, cfg = convert.load_clip_checkpoint(path)
    ref_tree, ref_cfg = ref_convert.load_clip_checkpoint(path)
    assert_trees_equal(tree, ref_tree)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref_cfg)


@pytest.fixture(scope="module")
def resnet_files(tmp_path_factory):
    """An RN-T@32 CLIP in OpenAI's layout (chip_smoke's export of random
    port towers, drawn BN statistics), as a fp16 `.pt` and, converted by
    the JAX package, as an `.npz`."""
    d = tmp_path_factory.mktemp("rn")
    clip = model.init_clip_params(clip_arch_config("RN-T@32"),
                                  torch.Generator().manual_seed(6))
    sd = chip_smoke.openai_state_dict(clip, torch.float16)
    pt = str(d / "rn.pt")
    torch.save(sd, pt)
    npz = str(d / "rn.npz")
    np.savez(npz, **flat(ref_convert.convert_clip_state_dict(sd)))
    return pt, npz


@pytest.mark.parametrize("kind", ["pt", "npz"])
def test_resnet_resolve_clip_params_loads_like_jax(resnet_files, kind,
                                                   monkeypatch):
    """resolve_clip_params takes a ResNet `.pt` and a ResNet `.npz` to the
    JAX package's towers, the arch table's config (RN-T@32) given. (The
    JAX `.npz` route reads only the structure and shapes of a random
    tree, whose every leaf the file replaces; its init is traced for
    them, not run eagerly, which takes seconds for a ResNet.)"""
    init = ref_model.init_clip_params
    monkeypatch.setattr(ref_model, "init_clip_params", lambda rng, cfg: (
        jax.tree_util.tree_map(lambda a: np.zeros(a.shape, a.dtype),
                               jax.eval_shape(lambda r: init(r, cfg),
                                              rng))))
    path = resnet_files[0 if kind == "pt" else 1]
    p = load_params(os.path.join(ROOT, "configs/debug/zsclip_tiny_params.py"))
    clip, pretrained = trainer.resolve_clip_params(
        p, clip_arch_config("RN-T@32"), torch.Generator().manual_seed(0),
        path, device="cpu")
    ref, ref_pretrained = ref_trainer.resolve_clip_params(
        p, ref_arch("RN-T@32"), jax.random.PRNGKey(0), path)
    assert pretrained and ref_pretrained
    got = convert.to_jax_flat(clip.named_parameters())
    want = flat(ref)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    copied = trainer.copy_clip(clip, clip.cfg, "cpu")
    assert trainer.snapshot_logit_scale(
        classifier.ClassifierConfig(model="ZSCLIP", clip=clip.cfg), copied,
        True).logit_scale == pytest.approx(1 / 0.07, rel=1e-3)


def test_resnet_fs_checkpoints_load_both_ways(tmp_path):
    """FS checkpoints of an RN-T@32 classifier (adapter + prompts, the
    frozen ResNet tower left out) as `.npz` and `.pth`: the JAX package's
    file loads into the port, the port's into the JAX package."""
    cfg_path = os.path.join(ROOT, "configs/debug/fsclip_tiny_params.py")
    pc = load_params(cfg_path)
    pc.clip_dict["arch"] = "RN-T@32"
    ref_cfg = ref_classifier.build_classifier_config(pc, ref_arch("RN-T@32"))
    clip = model.init_clip_params(clip_arch_config("RN-T@32"),
                                  torch.Generator().manual_seed(1))
    clip_tree = convert_method.unflatten(convert.to_jax_flat(
        clip.named_parameters()))
    ref_params = ref_classifier.init_classifier_params(
        jax.random.PRNGKey(5), ref_cfg, clip_params=clip_tree, n_classes=3)
    ref_npz = str(tmp_path / "ref.npz")
    ref_ckpt.save_trainable(ref_npz, ref_cfg, ref_params)
    sub = convert_method.unflatten(flat(trainable_subtree(
        ref_params, trainable_mask(ref_cfg, ref_params))))
    pth = str(tmp_path / "best.pth")
    convert_method.save_method_checkpoint(pth, sub)

    cfg = classifier.build_classifier_config(pc, clip_arch_config("RN-T@32"))
    want = flat(sub)
    for path in (ref_npz, pth):
        params = classifier.init_classifier_params(
            cfg, torch.Generator().manual_seed(0), clip=clip, n_classes=3)
        load_checkpoint(path, target=params)
        got = convert.to_jax_flat(params.named_parameters())
        assert {k.split("/")[0] for k in want} == {"adapter", "text_feats"}
        for k, v in want.items():
            np.testing.assert_array_equal(got[k], v, err_msg=k)
    ours = str(tmp_path / "ours.npz")
    save_trainable(ours, cfg, params)
    loaded, _ = ref_ckpt.load_checkpoint(ours)
    assert sorted(loaded) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(loaded[k], v, err_msg=k)


def test_resnet_ft_checkpoint_is_refused_like_jax():
    sd = {f"model.{k}": v for k, v in oracle_state_dict(
        ModifiedResNetOracle((1, 1, 1, 1), 8, 32, 4, 32)).items()
        if k.startswith("visual.")}
    for module in (convert_method, ref_method):
        with pytest.raises(ValueError, match="FT checkpoints with ResNet"):
            module.convert_method_state_dict(sd)


@pytest.mark.parametrize("dtype", [None, torch.float16])
def test_openai_layout_export_round_trips(dtype):
    """chip_smoke.openai_state_dict (port towers -> OpenAI keys) converts
    back to the JAX tree the towers came from."""
    tree = jax.tree_util.tree_map(np.asarray, ref_model.init_clip_params(
        jax.random.PRNGKey(2), ref_arch(ARCH)))
    clip = convert.clip_from_jax(tree, clip_arch_config(ARCH), device="cpu")
    sd = chip_smoke.openai_state_dict(clip, dtype)
    want = tree if dtype is None else jax.tree_util.tree_map(
        lambda a: a.astype(np.float16).astype(np.float32), tree)
    assert_trees_equal(convert.convert_clip_state_dict(sd), want)
    assert_trees_equal(ref_convert.convert_clip_state_dict(sd), want)


# -- resolve_clip_params -------------------------------------------------------


@pytest.fixture(scope="module")
def tiny_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("clip")
    sd = random_clip_state_dict(np.random.default_rng(4), **TINY)
    pt = str(d / "clip.pt")
    torch.save({k: v.half() for k, v in sd.items()}, pt)
    npz = str(d / "clip.npz")
    np.savez(npz, **flat(ref_convert.convert_clip_state_dict(sd)))
    return pt, npz, sd


def _resolve_both(path):
    cfg = load_params(os.path.join(ROOT, "configs/debug/zsclip_tiny_params.py"))
    clip, pretrained = trainer.resolve_clip_params(
        cfg, clip_arch_config(ARCH), torch.Generator().manual_seed(0), path,
        device="cpu")
    ref, ref_pretrained = ref_trainer.resolve_clip_params(
        ref_load_params(os.path.join(ROOT,
                                     "configs/debug/zsclip_tiny_params.py")),
        ref_arch(ARCH), jax.random.PRNGKey(0), path)
    assert pretrained and ref_pretrained
    return clip, ref


@pytest.mark.parametrize("kind", ["pt", "npz"])
def test_resolve_clip_params_loads_like_jax(tiny_files, kind):
    pt, npz, _ = tiny_files
    clip, ref = _resolve_both(pt if kind == "pt" else npz)
    got = convert.to_jax_flat(clip.named_parameters())
    want = flat(ref)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_resolve_clip_params_refusals(tiny_files, tmp_path):
    _, npz, sd = tiny_files
    p = load_params(os.path.join(ROOT, "configs/debug/zsclip_tiny_params.py"))
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(FileNotFoundError, match="not found"):
        trainer.resolve_clip_params(p, clip_arch_config(ARCH), gen,
                                    str(tmp_path / "none.pt"), device="cpu")
    with np.load(npz) as z:
        leaves = dict(z)
    partial = str(tmp_path / "partial.npz")
    np.savez(partial, **{k: v for k, v in leaves.items()
                         if k != "text/ln_final/scale"})
    with pytest.raises(ValueError, match="missing 1 parameter"):
        trainer.resolve_clip_params(p, clip_arch_config(ARCH), gen, partial,
                                    device="cpu")
    with pytest.raises(ValueError, match="missing 1 parameter"):
        ref_trainer.resolve_clip_params(p, ref_arch(ARCH),
                                        jax.random.PRNGKey(0), partial)
    wide = str(tmp_path / "wide.pt")
    torch.save(random_clip_state_dict(np.random.default_rng(0),
                                      **dict(TINY, width=128)), wide)
    with pytest.raises(ValueError, match="converted for"):
        trainer.resolve_clip_params(p, clip_arch_config(ARCH), gen, wide,
                                    device="cpu")
    # no checkpoint: random towers for a debug arch, refused otherwise
    _, pretrained = trainer.resolve_clip_params(
        p, clip_arch_config(ARCH), gen, device="cpu")
    assert not pretrained
    with pytest.raises(FileNotFoundError, match="--smoke"):
        trainer.resolve_clip_params(p, clip_arch_config("ViT-B/32"), gen,
                                    device="cpu")


# -- method checkpoints ------------------------------------------------------


def _visual_tree(seed):
    sd = random_clip_state_dict(np.random.default_rng(seed))
    return ref_convert.convert_vit_visual(sd)


def _lora(rng, targets, L=2, r=4, D=64):
    return {t: {"a": rng.normal(size=(L, r, D)).astype(np.float32),
                "b": rng.normal(size=(L, D, r)).astype(np.float32)}
            for t in targets}


def method_checkpoints():
    """Reference-layout state dicts, by kind: FS (adapter + prompts), an
    FT visual tower with prompts, LoRA on qkv and on qkvo."""
    rng = np.random.default_rng(9)
    text_feats = rng.normal(size=(5, 24)).astype(np.float32)
    mod = ref_adapter_module()
    fs = {f"adapter.{k}": v for k, v in mod.state_dict().items()}
    fs["text_feats"] = torch.tensor(text_feats)
    out = {"fs": fs}
    full = ref_method.export_method_state_dict(
        {"clip": {"visual": _visual_tree(1)}, "text_feats": text_feats})
    out["ft"] = {k: torch.tensor(np.asarray(v)) for k, v in full.items()}
    for targets in ("qkv", "qkvo"):
        sd = ref_method.export_method_state_dict(
            {"lora": _lora(rng, targets)}, clip_visual=_visual_tree(2))
        out[f"lora_{targets}"] = {k: torch.tensor(np.asarray(v))
                                  for k, v in sd.items()}
    return out


METHOD = method_checkpoints()


@pytest.mark.parametrize("kind", sorted(METHOD))
def test_method_checkpoint_converts_like_jax_both_ways(kind):
    sd = METHOD[kind]
    tree = convert_method.convert_method_state_dict(sd)
    assert_trees_equal(tree, ref_method.convert_method_state_dict(sd))
    base = _visual_tree(2) if kind.startswith("lora") else None
    got = convert_method.export_method_state_dict(tree, clip_visual=base)
    want = ref_method.export_method_state_dict(tree, clip_visual=base)
    assert sorted(got) == sorted(want) == sorted(sd)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]))
        np.testing.assert_array_equal(np.asarray(got[k]), sd[k].numpy())


def test_unflatten_and_merge_equal_jax():
    tree = convert_method.convert_method_state_dict(METHOD["lora_qkvo"])
    flat_tree = flat(tree)
    assert_trees_equal(convert_method.unflatten(flat_tree),
                       ref_method.unflatten(flat_tree))
    base = _visual_tree(2)
    assert_trees_equal(convert_method.jax_free_merge(base, tree["clip"]
                                                     ["visual"]),
                       ref_method.jax_free_merge(base, tree["clip"]
                                                 ["visual"]))


def test_load_method_checkpoint_is_weights_only(tmp_path, monkeypatch):
    path = str(tmp_path / "best.pth")
    convert_method.save_method_checkpoint(
        path, convert_method.convert_method_state_dict(METHOD["fs"]))
    assert_trees_equal(convert_method.load_method_checkpoint(path),
                       ref_method.load_method_checkpoint(path))
    unsafe = str(tmp_path / "unsafe.pth")
    torch.save({"state_dict": dict(METHOD["fs"]), "meta": object()}, unsafe)
    for module in (convert_method, ref_method):
        with pytest.raises(ValueError, match="EVENTCLIP_UNSAFE_TORCH_LOAD"):
            module.load_method_checkpoint(unsafe)
    monkeypatch.setenv("EVENTCLIP_UNSAFE_TORCH_LOAD", "1")
    assert_trees_equal(convert_method.load_method_checkpoint(unsafe),
                       ref_method.load_method_checkpoint(unsafe))


def test_pth_loads_into_classifier_params(tmp_path):
    """A reference-layout FS .pth (exported from a JAX FS classifier's
    trainable leaves) loads into the port's ClassifierParams to the leaves
    the JAX load_checkpoint gives."""
    cfg_path = os.path.join(ROOT, "configs/debug/fsclip_tiny_params.py")
    ref_cfg = ref_classifier.build_classifier_config(
        ref_load_params(cfg_path), ref_arch(ARCH))
    ref_params = ref_classifier.init_classifier_params(
        jax.random.PRNGKey(5), ref_cfg, n_classes=3)
    sub = convert_method.unflatten(flat(trainable_subtree(
        ref_params, trainable_mask(ref_cfg, ref_params))))
    path = str(tmp_path / "best.pth")
    convert_method.save_method_checkpoint(path, sub)

    cfg = classifier.build_classifier_config(load_params(cfg_path),
                                             clip_arch_config(ARCH))
    params = classifier.init_classifier_params(
        cfg, torch.Generator().manual_seed(0), n_classes=3)
    load_checkpoint(path, target=params)
    want, _ = ref_ckpt.load_checkpoint(path)
    got = convert.to_jax_flat(params.named_parameters())
    assert want and set(want) <= set(got)
    assert {k.split("/")[0] for k in want} == {"adapter", "text_feats"}
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    flat_pth, extra = load_checkpoint(path)
    assert sorted(flat_pth) == sorted(want) and extra == {}
