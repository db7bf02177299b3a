"""The one seam of the vision towers (models/clip/model.py `TOWERS`).

The primitives (models/clip/layers.py) sit below the tower modules
(resnet.py, eva.py), which sit below model.py, and no module there
imports inside a function. `CLIP` builds the tower the table names for
each debug arch, and `classifier_forward` runs it on the CPU. Each caller
that takes an up-front option (int8, LoRA at init, token pruning, export,
f32 on the card) refuses exactly the towers whose module declares the
refusal, with the exception type and text the older tests pin
(tests/test_torch_resnet.py, test_torch_quant.py, test_torch_eva02.py),
and takes the option everywhere else."""

import ast
import pathlib
import re

import numpy as np
import pytest
import torch

from eventclip_tpu_torch.export import export_predictor
from eventclip_tpu_torch.models.classifier import (ClassifierConfig,
                                                   classifier_forward,
                                                   init_classifier_params)
from eventclip_tpu_torch.models.clip import config, eva, model, resnet
from eventclip_tpu_torch.models.clip.config import clip_arch_config
from eventclip_tpu_torch.ops import quant
from eventclip_tpu_torch.serve import Predictor
from eventclip_tpu_torch.utils.config import Params

CLIP_DIR = pathlib.Path(model.__file__).parent
# each module of the seam and the modules of models/clip it may import
BELOW = {"layers": set(), "resnet": {"layers"}, "eva": {"layers"},
         "model": {"layers", "resnet", "eva"}}
ARCHS = ("ViT-T/8@32", "RN-T@32", "EVA02-T/8@48", "EVA02-T/8@32")
TOWER = {config.VisionConfig: model.VisionTower,
         config.ResNetVisionConfig: resnet.ResNetVisionTower,
         config.EVAVisionConfig: eva.EVAVisionTower}
RESNET_INT8 = ("int8 quantization supports the ViT towers only (ResNet "
               "archs run bf16)")
# (arch, option) -> the exception and the text it must carry; every other
# pair is taken
REFUSED = {("RN-T@32", "int8"): (ValueError, re.escape(RESNET_INT8)),
           ("RN-T@32", "LoRA"): (TypeError,
                                 "LoRA targets the ViT attention")}
for _arch in ARCHS[2:]:
    for _option in ("int8", "token pruning", "export", "f32 on the card"):
        REFUSED[_arch, _option] = (ValueError, _option)
    REFUSED[_arch, "LoRA"] = (TypeError, "LoRA")
OPTIONS = ("int8", "LoRA", "token pruning", "export", "f32 on the card")
# a tower that takes f32 on the card can only show it on one
CASES = [(a, o) for a in ARCHS for o in OPTIONS
         if o != "f32 on the card" or (a, o) in REFUSED
         or torch.cuda.is_available()]


@pytest.mark.parametrize("name", sorted(BELOW))
def test_imports_point_one_way_and_none_is_inside_a_function(name):
    tree = ast.parse((CLIP_DIR / f"{name}.py").read_text())
    inner = [n.lineno for top in tree.body for n in ast.walk(top)
             if n is not top and isinstance(n, (ast.Import, ast.ImportFrom))]
    assert not inner, f"{name}.py imports inside a function at {inner}"
    seam = set()
    for n in tree.body:
        if isinstance(n, ast.ImportFrom) and n.level == 1:
            seam |= ({n.module} if n.module else
                     {a.name for a in n.names})
    assert seam - {"config"} <= BELOW[name], seam


def _classifier(arch, gen):
    cfg = ClassifierConfig(model="ZSCLIP", clip=clip_arch_config(arch))
    return cfg, init_classifier_params(cfg, gen, n_classes=3)


@pytest.mark.parametrize("arch", ARCHS)
def test_the_table_builds_and_runs_each_tower(arch):
    vision = clip_arch_config(arch).vision
    assert model.TOWERS[type(vision)].module is TOWER[type(vision)]
    cfg, params = _classifier(arch, torch.Generator().manual_seed(0))
    assert type(params.clip.visual) is TOWER[type(vision)]
    s = vision.image_size
    imgs = torch.randn((2, 3, 3, s, s),
                       generator=torch.Generator().manual_seed(1))
    valid = torch.tensor([[True, True, False], [True, False, False]])
    with torch.no_grad():
        probs = classifier_forward(params, cfg, imgs, valid)["probs"]
    assert probs.shape == (2, 3) and torch.isfinite(probs).all()


def _predictor(arch, **kw):
    cfg = clip_arch_config(arch)
    clip = model.init_clip_params(cfg, torch.Generator().manual_seed(0))
    text = np.random.default_rng(0).normal(
        size=(3, cfg.vision.output_dim)).astype(np.float32)
    params = Params(model="ZSCLIP", dataset="n_caltech",
                    bf16=kw.pop("bf16", True),
                    quantize_args={"max_imgs": 2, "N": 20000,
                                   "split_method": "event_count",
                                   "convert_method": "event_histogram",
                                   "grayscale": True,
                                   "count_non_zero": False,
                                   "background_mask": True},
                    clip_dict={"arch": arch, "agg_func": "mean",
                               "prompt": "a point cloud image of a {}"})
    return Predictor(params, ["a", "b", "c"], clip_params=clip,
                     text_feats=text / np.linalg.norm(text, axis=-1,
                                                      keepdims=True),
                     batch_size=4, device=kw.pop("device", "cpu"), **kw)


def _take(arch, option, tmp_path):
    """Ask `option`'s caller to take it for `arch`; return what shows it
    was taken."""
    gen = torch.Generator().manual_seed(0)
    if option == "int8":
        _, params = _classifier(arch, gen)
        out = quant.quantize_classifier_params(params)
        return isinstance(out.clip.visual.patch_embed, quant.QWeight)
    if option == "LoRA":
        cfg = ClassifierConfig(model="FTCLIP", clip=clip_arch_config(arch),
                               lora=4, ft_mode="lora")
        return init_classifier_params(cfg, gen, n_classes=3).lora is not None
    if option == "token pruning":
        return _predictor(arch, prune_tokens=8)._cfg.keep_tokens == 8
    if option == "export":
        export_predictor(_predictor(arch), str(tmp_path / "bundle.pt"))
        return (tmp_path / "bundle.pt").exists()
    return _predictor(arch, bf16=False, device="cuda").device.type == "cuda"


@pytest.mark.parametrize("arch,option", CASES)
def test_each_caller_refuses_as_the_tower_declares(arch, option, tmp_path):
    if (arch, option) not in REFUSED:
        assert _take(arch, option, tmp_path)
        return
    error, text = REFUSED[arch, option]
    with pytest.raises(error, match=text) as got:
        _take(arch, option, tmp_path)
    assert type(got.value) is error
