"""The port's CLIs equal the root CLIs of the JAX package.

On a 3-class synthetic N-Caltech tree, with a tiny OpenAI-layout `.pt`
(fp16, as the releases are) and a synthetic BPE merge table:

- `python -m eventclip_tpu_torch.cli.test` gives the same sample count and
  the same probs / logits accuracies as the root test.py's `evaluate`
  (loaded by file path: `test` is also the standard library's test
  package), and per-sample probabilities within the f32 tolerance
  (rtol 1e-4, atol 1e-5; both run f32, --fp32);
- `cli.train` trains the debug FS config for one epoch on the CPU and
  writes a best.npz that the JAX load_checkpoint reads; that checkpoint
  and its reference-layout `.pth` export evaluate to the JAX CLI's
  accuracies, the `.pth` through a --train_shots sweep;
- `--int8`, `--int8_calib` and `--prune_tokens` give the root CLI's
  printed accuracies, and so does `--arch RN-T@32` (a ResNet tower);
- the argument overrides equal the root CLIs' (`--profile N` sets
  `profile_steps` as the root CLI does), and the flags that are not
  ported raise SystemExit naming their ROADMAP item (7d, 7e);
- under the JAX triple or torchrun's env, two `cli.train` processes join
  one data-parallel run (each loads half of every global batch, both take
  the same steps) and only rank 0 writes `metrics.jsonl`, `run_id.txt`
  and the checkpoints.
"""

import gzip
import importlib.util
import json
import os
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eventclip_tpu.data import build_dataset as ref_build_dataset
from eventclip_tpu.data.loader import collate as ref_collate
from eventclip_tpu.engine.checkpoint import load_checkpoint as ref_load
from eventclip_tpu.models.classifier import \
    classifier_forward as ref_forward
from eventclip_tpu.ops.rasterize import \
    rasterize_for_clip as ref_rasterize
from eventclip_tpu_torch.cli import test as cli_test
from eventclip_tpu_torch.cli import train as cli_train
from eventclip_tpu_torch.models.classifier import classifier_forward
from eventclip_tpu_torch.models.clip.convert_method import (
    save_method_checkpoint, unflatten)
from eventclip_tpu_torch.ops.rasterize import rasterize_for_clip

from .test_e2e import make_tree
from .test_tokenizer import MERGES
from .torch_oracle import random_clip_state_dict

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ZS = os.path.join(ROOT, "configs/debug/zsclip_tiny_params.py")
FS = os.path.join(ROOT, "configs/debug/fsclip_tiny_params.py")


def _load_root_cli(name):
    spec = importlib.util.spec_from_file_location(
        f"root_{name}_cli", os.path.join(ROOT, f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


REF_TEST = _load_root_cli("test")
REF_TRAIN = _load_root_cli("train")


def ref_args(module, argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", [f"{module.__name__}.py"] + argv)
    return module.parse_args()


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """(tree, .pt, vocab); the vocab is on EVENTCLIP_BPE_PATH meanwhile."""
    d = tmp_path_factory.mktemp("cli")
    tree = make_tree(str(d / "tree"))
    vocab = str(d / "bpe.txt.gz")
    with gzip.open(vocab, "wt", encoding="utf-8") as f:
        f.write("#version: 0.2\n"
                + "\n".join(" ".join(m) for m in MERGES) + "\n")
    sd = random_clip_state_dict(
        np.random.default_rng(0), width=64, layers=2, patch=8, image=32,
        t_width=32, t_layers=2, vocab=49408, context=77, embed=32)
    pt = str(d / "clip.pt")
    torch.save({k: v.half() for k, v in sd.items()}, pt)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("EVENTCLIP_BPE_PATH", vocab)
        yield tree, pt, vocab


def _eval_lines(out):
    return [ln for ln in out.splitlines()
            if ln.startswith(("Evaluated", "\taccuracy"))]


def test_cli_test_equals_root_evaluate(files, capsys, monkeypatch):
    tree, pt, _ = files
    argv = ["--params", ZS, "--clip_ckpt", pt, "--data_root", tree,
            "--fp32"]
    res = cli_test.main(argv + ["--cpu"])
    got = _eval_lines(capsys.readouterr().out)
    args = ref_args(REF_TEST, argv, monkeypatch)
    params, _ = REF_TEST.load_and_override(args)
    ref_ctx = REF_TEST.build_eval_context(params, args)
    want = REF_TEST.evaluate(params, args, ctx=ref_ctx)
    assert got == _eval_lines(capsys.readouterr().out)
    assert got[0] == "Evaluated 12 samples"
    assert (res["probs_acc"], res["logits_acc"]) == want

    # per-sample probabilities over the whole val set, each package's
    # context (towers, text features, pipeline) on the same windows
    ctx = res["ctx"]
    batch = ref_collate([ref_build_dataset(params, val_only=True)[i]
                         for i in range(12)])
    spec, pp = ref_ctx["raster"]
    want = ref_forward(ref_ctx["template"], ref_ctx["cls_cfg"],
                       ref_rasterize(spec, pp, jnp.asarray(batch["windows"])),
                       jnp.asarray(batch["valid_mask"]))["probs"]
    spec, pp = ctx["raster"]
    with torch.inference_mode():
        got = classifier_forward(
            ctx["template"], ctx["cls_cfg"],
            rasterize_for_clip(spec, pp, torch.from_numpy(batch["windows"])),
            torch.from_numpy(batch["valid_mask"]))["probs"]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)


def test_cli_train_then_test_npz_and_pth(files, tmp_path, capsys,
                                         monkeypatch):
    tree, _, _ = files
    base = str(tmp_path / "ckpt")
    trainer = cli_train.main(["--params", FS, "--data_root", tree, "--cpu",
                              "--max_epochs", "1", "--num_shots", "2",
                              "--ckpt_base", base])
    assert trainer.pretrained is False and trainer.optimizer.count > 0
    models = os.path.join(base, "fsclip_tiny_params-2shot", "models")
    best = os.path.join(models, "best.npz")
    flat, extra = ref_load(best)
    assert {k.split("/")[0] for k in flat} == {"adapter", "text_feats"}
    assert int(extra["step"]) == trainer.optimizer.count
    capsys.readouterr()

    argv = ["--params", FS, "--data_root", tree, "--weight", best, "--fp32"]
    res = cli_test.main(argv + ["--cpu"])
    got = _eval_lines(capsys.readouterr().out)
    args = ref_args(REF_TEST, argv, monkeypatch)
    params, _ = REF_TEST.load_and_override(args)
    want = REF_TEST.evaluate(params, args, weight=best)
    assert got == _eval_lines(capsys.readouterr().out)
    assert (res["probs_acc"], res["logits_acc"]) == want

    # the same weights in the reference's .pth layout, found by a sweep
    save_method_checkpoint(os.path.join(models, "best.pth"), unflatten(flat))
    shutil.move(best, str(tmp_path / "moved.npz"))
    assert cli_test.find_weight(models) == REF_TEST.find_weight(models) == \
        os.path.join(models, "best.pth")
    sweep = cli_test.main(["--params", FS, "--data_root", tree, "--fp32",
                           "--cpu", "--train_shots", "2", "--ckpt_base",
                           base])
    assert sweep["probs"] == [round(want[0] * 100.0, 2)]
    assert sweep["logits"] == [round(want[1] * 100.0, 2)]


OVERRIDES = [
    ["--params", "configs/fsclip/joint_adapter/joint_fsclip_ncars_params.py",
     "--num_shots", "10", "--N", "5", "--fp32", "--accum", "2"],
    ["--params", "configs/fsclip/joint_adapter/"
     "joint_fsclip_nin_mini_params-vitb32.py", "--num_shots", "1",
     "--max_epochs", "3", "--data_root", "/data/mini"],
    ["--params", "configs/ftclip/ft_text_fsclip_nin_params.py"],
    ["--params", "configs/fsclip/joint_adapter/"
     "joint_fsclip_ncaltech_params.py", "--profile", "3"],
]


@pytest.mark.parametrize("argv", OVERRIDES,
                         ids=["ncars", "mini", "ft", "profile"])
def test_train_overrides_equal_root(argv, monkeypatch):
    argv = [os.path.join(ROOT, a) if a.startswith("configs/") else a
            for a in argv]
    got = cli_train.load_and_override(cli_train.parse_args(argv))
    want = REF_TRAIN.load_and_override(ref_args(REF_TRAIN, argv, monkeypatch))
    assert got[1] == want[1]
    assert got[0].to_dict() == want[0].to_dict()


@pytest.mark.parametrize("extra", [
    ["--N", "30", "--arch", "ViT-B/32", "--prompt", "a {}", "--bs", "16"],
    ["--fp32", "--data_root", "/data/x"],
])
def test_test_overrides_equal_root(extra, monkeypatch):
    argv = ["--params", os.path.join(ROOT, "configs/zsclip/"
                                     "zsclip_ncaltech_params.py")] + extra
    got = cli_test.load_and_override(cli_test.parse_args(argv))
    want = REF_TEST.load_and_override(ref_args(REF_TEST, argv, monkeypatch))
    assert got[1] == want[1]
    assert got[0].to_dict() == want[0].to_dict()


@pytest.mark.parametrize("flags", [
    ["--int8"], ["--int8", "--int8_calib", "1"], ["--prune_tokens", "8"],
    ["--int8", "--prune_tokens", "8"],
], ids=["int8", "int8-calib", "pruned", "int8-pruned"])
def test_int8_and_pruning_flags_equal_root_evaluate(files, capsys,
                                                    monkeypatch, flags):
    """The fast-path flags through both CLIs (f32): the same printed
    sample count and accuracies; with --int8 the float template stays as
    it was (a sweep quantizes each checkpoint anew)."""
    tree, pt, _ = files
    argv = ["--params", ZS, "--clip_ckpt", pt, "--data_root", tree,
            "--fp32"] + flags
    res = cli_test.main(argv + ["--cpu"])
    got = _eval_lines(capsys.readouterr().out)
    args = ref_args(REF_TEST, argv, monkeypatch)
    params, _ = REF_TEST.load_and_override(args)
    want = REF_TEST.evaluate(params, args)
    assert got == _eval_lines(capsys.readouterr().out)
    assert got[0] == "Evaluated 12 samples"
    assert (res["probs_acc"], res["logits_acc"]) == want
    visual = res["ctx"]["template"].clip.visual
    assert isinstance(visual.patch_embed, torch.nn.Parameter)
    if "--prune_tokens" in flags:
        assert res["ctx"]["cls_cfg"].keep_tokens == 8


def test_resnet_arch_eval_equals_root(files, capsys, monkeypatch,
                                      tmp_path):
    """`--arch RN-T@32` (the reference's arch sweep takes five ResNets):
    the same printed sample count and accuracies as the root test.py,
    towers from one `.npz`, and one set of text features handed to both
    (RN-T@32's 128-id text tower cannot embed BPE ids)."""
    import eventclip_tpu.engine.trainer as ref_trainer
    import eventclip_tpu.models.clip.model as ref_model
    from eventclip_tpu_torch.models.clip import convert, model
    from eventclip_tpu_torch.models.clip.config import clip_arch_config

    tree, _, _ = files
    clip = model.init_clip_params(clip_arch_config("RN-T@32"),
                                  torch.Generator().manual_seed(8))
    npz = str(tmp_path / "rn.npz")
    np.savez(npz, **convert.to_jax_flat(clip.named_parameters()))
    feats = np.random.default_rng(3).normal(size=(3, 32)).astype(np.float32)
    feats /= np.linalg.norm(feats, axis=-1, keepdims=True)
    monkeypatch.setattr(ref_trainer, "build_text_features",
                        lambda *a: jnp.asarray(feats))
    monkeypatch.setattr(cli_test, "build_text_features",
                        lambda *a: torch.from_numpy(feats))
    init = ref_model.init_clip_params
    # the JAX .npz route reads only a random tree's structure and shapes
    monkeypatch.setattr(ref_model, "init_clip_params", lambda rng, cfg: (
        jax.tree_util.tree_map(lambda a: np.zeros(a.shape, a.dtype),
                               jax.eval_shape(lambda r: init(r, cfg),
                                              rng))))
    argv = ["--params", ZS, "--arch", "RN-T@32", "--clip_ckpt", npz,
            "--data_root", tree, "--fp32"]
    res = cli_test.main(argv + ["--cpu"])
    got = _eval_lines(capsys.readouterr().out)
    args = ref_args(REF_TEST, argv, monkeypatch)
    params, _ = REF_TEST.load_and_override(args)
    want = REF_TEST.evaluate(params, args)
    assert got == _eval_lines(capsys.readouterr().out)
    assert got[0] == "Evaluated 12 samples"
    assert (res["probs_acc"], res["logits_acc"]) == want
    assert res["ctx"]["cls_cfg"].clip.name == "RN-T@32"


def launch_env(kind):
    """The coordination env of rank r: the JAX triple that
    scripts/submit_run.sh exports, or torchrun's."""
    def env(rank, port):
        if kind == "jax":
            return {"JAX_COORDINATOR_ADDRESS": f"localhost:{port}",
                    "JAX_NUM_PROCESSES": "2", "JAX_PROCESS_ID": str(rank)}
        return {"MASTER_ADDR": "localhost", "MASTER_PORT": str(port),
                "WORLD_SIZE": "2", "RANK": str(rank),
                "LOCAL_RANK": str(rank)}
    return env


@pytest.mark.parametrize("kind", ["jax", "torchrun"])
def test_train_cli_joins_one_run_under_launch_env(files, tmp_path, kind):
    """ROADMAP fault 1: two `cli.train` processes under a launcher's env
    train one run; rank 0 alone writes."""
    from .test_torch_parallel import spawn_ranks

    tree, _, _ = files
    base = tmp_path / "ckpt"
    argv = ["train", "--params", FS, "--cpu", "--data_root", tree,
            "--max_epochs", "1", "--san_check_val_step", "1",
            "--ckpt_base", str(base)]
    outs = spawn_ranks("tests.torch_ddp_worker", argv,
                       env_of=launch_env(kind))
    for rank, (rc, log) in enumerate(outs):
        assert rc == 0, log
        assert f"SHARD {rank} 2" in log, log
        # 18 training streams, global batch 4: 4 updates on both ranks
        assert "STEPS 4" in log, log
    exp = base / "fsclip_tiny_params"
    lines = [json.loads(ln) for ln in open(exp / "metrics.jsonl")]
    assert [ln["split"] for ln in lines] == ["val", "train", "val"]
    assert lines[1]["steps"] == 4
    assert lines[2]["n"] == 12  # every testing stream once
    assert {os.path.relpath(os.path.join(d, f), exp)
            for d, _, fs in os.walk(exp) for f in fs
            if not f.endswith(".gif")} >= {
        "run_id.txt", "metrics.jsonl", "models/best.npz",
        "models/model_4.npz", "models/resume.pt"}
    # a multi-rank run writes no validation GIFs (one process only)
    assert not (exp / "viz").exists()
