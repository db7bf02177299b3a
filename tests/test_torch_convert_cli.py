"""The port's checkpoint converters (eventclip_tpu_torch/cli/convert_clip.py,
cli/convert_checkpoint.py) against the JAX package's scripts
(scripts/convert_clip.py, scripts/convert_checkpoint.py), each run as a
subprocess on the same inputs: a synthetic OpenAI `.pt`
(tests/torch_oracle.py::random_clip_state_dict) and reference-shaped
method `.pth` files (FS adapter + prompts, a fine-tuned visual tower,
LoRA on qkvo; tests/test_torch_convert.py::METHOD). The files written
must be equal, key for key and array for array (dtypes too), in both
directions (.pth -> .npz and .npz -> .pth); the printed lines too.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from .test_torch_convert import METHOD
from .torch_oracle import random_clip_state_dict

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(cmd):
    r = subprocess.run([sys.executable] + cmd, cwd=ROOT, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    return r.stdout


def _both(tool, src, out, *extra):
    """((port stdout, its file), (JAX stdout, its file)) of one conversion
    `tool src out [extra]`; each side writes `out` with its own suffix."""
    stem, ext = os.path.splitext(out)
    mine, theirs = stem + "_port" + ext, stem + "_jax" + ext
    port = _run(["-m", f"eventclip_tpu_torch.cli.{tool}", src, mine,
                 *extra])
    ref = _run([os.path.join("scripts", f"{tool}.py"), src, theirs, *extra])
    return (port, mine), (ref, theirs)


def _npz_equal(a, b):
    with np.load(a) as x, np.load(b) as y:
        assert sorted(x.files) == sorted(y.files)
        for k in x.files:
            assert x[k].dtype == y[k].dtype, k
            np.testing.assert_array_equal(x[k], y[k], err_msg=k)


def _pth_equal(a, b):
    x = torch.load(a, weights_only=True)["state_dict"]
    y = torch.load(b, weights_only=True)["state_dict"]
    assert sorted(x) == sorted(y)
    for k in x:
        assert x[k].dtype == y[k].dtype, k
        assert torch.equal(x[k], y[k]), k


@pytest.fixture(scope="module")
def clip_pt(tmp_path_factory):
    path = tmp_path_factory.mktemp("clip") / "tiny_clip.pt"
    torch.save(random_clip_state_dict(np.random.default_rng(2)), path)
    return str(path)


def test_convert_clip_equals_jax(clip_pt, tmp_path):
    (port, a), (ref, b) = _both("convert_clip", clip_pt,
                                str(tmp_path / "clip.npz"))
    _npz_equal(a, b)
    # the same lines, but for the output path's name
    assert port.replace(a, "OUT") == ref.replace(b, "OUT")
    assert port.startswith("ViT-64/8@32: wrote")


@pytest.mark.parametrize("kind", ["fs", "ft", "lora_qkvo"])
def test_convert_checkpoint_equals_jax_both_ways(kind, clip_pt, tmp_path):
    """.pth -> .npz (import), then each side's npz -> .pth (export; LoRA
    with the base tower from the `.pt` the LoRA checkpoint was drawn on)."""
    src = str(tmp_path / "ref.pth")
    torch.save({"state_dict": METHOD[kind]}, src)
    (port, a), (ref, b) = _both("convert_checkpoint", src,
                                str(tmp_path / "best.npz"))
    _npz_equal(a, b)
    assert port.replace(a, "OUT") == ref.replace(b, "OUT")
    base = [clip_pt] if kind.startswith("lora") else []
    (_, c), (_, d) = _both("convert_checkpoint", a,
                           str(tmp_path / "back.pth"), *base)
    _pth_equal(c, d)
    # and the round trip gives the reference's file back
    back = torch.load(c, weights_only=True)["state_dict"]
    assert sorted(back) == sorted(METHOD[kind])
    for k, v in METHOD[kind].items():
        assert torch.equal(back[k], v.to(back[k].dtype)), k


def test_converters_print_usage_and_exit_1():
    for tool in ("convert_clip", "convert_checkpoint"):
        r = subprocess.run([sys.executable, "-m",
                            f"eventclip_tpu_torch.cli.{tool}"], cwd=ROOT,
                           capture_output=True, text=True, timeout=120)
        assert r.returncode == 1 and tool in r.stdout, r.stdout + r.stderr
