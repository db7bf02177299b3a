"""The port's real-asset parity harness
(eventclip_tpu_torch/cli/parity_check.py) end to end on the CPU, as
tests/test_scripts.py runs the JAX harness
(scripts/parity_check.py): a synthetic tiny OpenAI `.pt`, the
`make_tree` dataset tree, a reference-shaped FS method `.pth`, and a
2-shot training run of one epoch with the `.pth` round trip. The same
assertions as the JAX test: the towers within the default 2e-3 of the
torch oracle, the asset-gated stages skipped with their notes, the method
eval and the few-shot leg ok, the round trip bit-equal; and the result
JSON has the JAX harness's key set.
"""

import ast
import json
import os
import subprocess
import sys

import numpy as np
import torch

from .test_e2e import make_tree
from .torch_oracle import random_clip_state_dict

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_result_keys():
    """The top-level keys scripts/parity_check.py writes: its `result`
    dict literal's and every `result["..."] = ...` of the script."""
    with open(os.path.join(ROOT, "scripts", "parity_check.py")) as f:
        tree = ast.parse(f.read())
    keys = set()
    for node in ast.walk(tree):
        if not isinstance(node, ast.Assign):
            continue
        for t in node.targets:
            if (isinstance(t, ast.Name) and t.id == "result"
                    and isinstance(node.value, ast.Dict)):
                keys |= {k.value for k in node.value.keys}
            if (isinstance(t, ast.Subscript) and isinstance(t.value, ast.Name)
                    and t.value.id == "result"):
                keys.add(t.slice.value)
    return keys


def _method_pth(path):
    """A reference-shaped FS checkpoint (nerv 'state_dict' wrapper): the
    adapter of configs/debug/fsclip_tiny_params.py (d_model 16, 2 heads,
    2 layers) on the synthetic tower's embed dim 48, 3 classes."""
    torch.manual_seed(0)
    enc = torch.nn.TransformerEncoderLayer(
        16, 2, 64, norm_first=True, batch_first=True)

    class RefAdapter(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.transformer_encoder = torch.nn.TransformerEncoder(enc, 2)
            self.in_proj = torch.nn.Linear(48, 16)
            self.out_proj = torch.nn.Linear(16, 48)

    msd = {f"adapter.{k}": v for k, v in RefAdapter().state_dict().items()}
    msd["text_feats"] = torch.randn(3, 48)
    torch.save({"state_dict": msd}, path)


def test_parity_check_harness_synthetic(tmp_path):
    tree = make_tree(str(tmp_path / "tree"))
    ckpt = tmp_path / "tiny_clip.pt"
    torch.save(random_clip_state_dict(np.random.default_rng(7)), ckpt)
    method_pth = tmp_path / "method_best.pth"
    _method_pth(method_pth)

    env = {k: v for k, v in os.environ.items()
           if k not in ("EVENTCLIP_BPE_PATH", "EVENTCLIP_ALLOW_RANDOM_TEXT")}
    r = subprocess.run(
        [sys.executable, "-m", "eventclip_tpu_torch.cli.parity_check",
         "--clip_ckpt", str(ckpt), "--data_root", tree, "--bs", "8",
         "--method_ckpt", str(method_pth),
         "--method_params", "configs/debug/fsclip_tiny_params.py",
         "--fs_shots", "2", "--fs_epochs", "1", "--fs_roundtrip",
         "--fs_params", "configs/debug/fsclip_tiny_params.py",
         "--workdir", str(tmp_path / "fswork"), "--cpu"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600,
    )
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    with open(tmp_path / "PARITY_RESULT.json") as f:
        res = json.load(f)
    assert set(res) == _jax_result_keys()
    assert res["ok"] is True
    assert res["tower_parity"]["ok"] is True
    assert res["tower_parity"]["image_max_abs_diff"] < 2e-3
    assert res["tower_parity"]["text_max_abs_diff"] < 2e-3
    assert os.path.exists(res["converted_npz"])
    # asset-gated stages skip with notes, never silently pass
    assert res["tokenizer"]["ok"] is None and "BPE" in res["tokenizer"]["note"]
    assert res["zero_shot"]["ok"] is None

    # the FS/FT leg: a reference .pth through cli.test's main on the
    # checkpoint's inferred tower; the prompt-tuned leaf comes from the
    # checkpoint (only the overwritten init was random, BPE being absent)
    me = res["method_evals"][0]
    assert me["ok"] is True, me
    assert me["arch"] == res["arch"]
    assert me["random_text_init"] is True
    assert 0.0 <= me["probs_top1"] <= 1.0

    # the train-from-converted-weights leg, incl. the .pth round trip
    fs = res["few_shot"]
    assert fs["ok"] is True, fs
    assert os.path.exists(fs["weight"])
    assert fs["params"].endswith("_ckptarch.py")  # derived-arch config
    assert fs["roundtrip"]["bit_equal"] is True
    assert fs["roundtrip"]["probs_top1"] == fs["probs_top1"]
    # each stage that ran reports its wall seconds
    assert all(res[k]["wall_s"] > 0
               for k in ("tower_parity", "tokenizer", "few_shot"))


def test_tower_stage_on_a_resnet_checkpoint():
    """The harness's tower stage on a tiny ResNet state dict (batch-norm
    statistics drawn, as tests/test_real_assets.py draws them for the JAX
    harness): the image tower against tests/test_resnet.py's torch
    ModifiedResNet, loaded without JAX, within 2e-4; the int8 route
    refuses the ResNet tower."""
    from eventclip_tpu_torch.cli import parity_check
    from eventclip_tpu_torch.models.clip.convert import (
        convert_clip_state_dict, infer_config_from_state_dict)

    from .test_resnet import ModifiedResNetOracle, oracle_state_dict

    torch.manual_seed(0)
    m = ModifiedResNetOracle(layers=(1, 1, 1, 1), width=16, image_size=64,
                             heads=4, output_dim=32).eval()
    with torch.no_grad():
        for mod in m.modules():
            if isinstance(mod, torch.nn.BatchNorm2d):
                mod.running_mean.normal_(0.0, 0.2)
                mod.running_var.uniform_(0.5, 1.5)
    sd = {k: v.float() for k, v in oracle_state_dict(m).items()}
    assert parity_check.load_resnet_oracle().__name__ == "ModifiedResNetOracle"
    res = parity_check.tower_parity(sd, convert_clip_state_dict(sd),
                                    infer_config_from_state_dict(sd), 2e-4,
                                    torch.device("cpu"))
    assert res["ok"] is True, res
    assert res["image_max_abs_diff"] < 2e-4
    assert res["text_max_abs_diff"] < 2e-4
