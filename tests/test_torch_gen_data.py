"""`python -m eventclip_tpu_torch.cli.gen_data` equals the root gen_data.py.

The root CLI's `main` is loaded by file path and both run in-process on
the same tree with the same arguments (the port with --cpu; the JAX side
on the suite's 8 virtual CPU devices). Each case compares the printed
selection report (from "Class stats:" on: per-class GT / selected /
correct counts, the low-precision count, the totals, the accuracy) and the
written tree as {relative path: real path}, symlinks and empty class
folders included.

Random towers give nearly one-hot probabilities of one class for every
stream, on which the filters select all or nothing. So the cases that
test the filters feed both packages the same probabilities: each
package's rasterizer is replaced by an exact integer statistic of every
view's events (`_stat`: sums of int16 coordinates, exact in f32) and its
classifier forward by the same function of it (`_probs`: a sine of the
view-mean statistic, softmaxed), so the probabilities spread over the
classes and agree to float rounding (≈1e-7). Every threshold below sits
at a gap of at least GAP = 1e-3 in those probabilities (asserted on the
port's own table, `_table`), as does every top-k cut. Cases:

- N-Caltech, ZS teacher, --tta --tta_consistent --tta_min_prob --topk 2;
- N-ImageNet (wnid folders, extracted_val linked), ZS teacher, --tta;
- a 101-class N-Caltech tree holding the shipped 1-shot split: the FS
  teacher's --weight (a checkpoint the JAX package wrote) with
  --gt_shots 1, every GT file merged under its inverted folder
  (Faces_easy -> Faces);
- real forwards: --int8 --int8_calib 1 --prune_tokens 8 on the ViT-T/8@32
  `.pt` (val_batch_size 8: both packages sweep the same streams for the
  calibration), and an RN-T@32 teacher (`.npz` towers, the same text
  features handed to both), f32;
- the factored functions on a hand-made table; the refusal of int8 on a
  ResNet teacher;
- two gloo ranks (the JAX triple's env, `--cpu`) labelling the split in
  shards, plain with --tta and with --int8 --int8_calib 1: rank 0's
  report and tree equal the one-process run's (which the cases above
  hold to the root CLI), and rank 1 prints no report.
"""

import contextlib
import gzip
import importlib.util
import io
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from eventclip_tpu.engine import checkpoint as ref_ckpt
from eventclip_tpu.models import classifier as ref_classifier
from eventclip_tpu.models.clip import convert as ref_convert
from eventclip_tpu.models.clip import model as ref_model
from eventclip_tpu.models.clip.config import clip_arch_config as ref_arch
from eventclip_tpu.utils.config import load_params as ref_load_params
from eventclip_tpu_torch.cli import gen_data
from eventclip_tpu_torch.data import build_dataset, collate
from eventclip_tpu_torch.models.clip import model
from eventclip_tpu_torch.models.clip.config import clip_arch_config

from .test_e2e import make_nin_tree, make_tree
from .test_tokenizer import MERGES
from .torch_oracle import random_clip_state_dict

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GAP = 1e-3
_spec = importlib.util.spec_from_file_location(
    "root_gen_data_cli", os.path.join(ROOT, "gen_data.py"))
REF_GEN = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(REF_GEN)

CONFIG = """
from eventclip_tpu.utils.config import Params

class EventCLIPParams(Params):
    gpus = 1
    dataset = {dataset!r}
    train_batch_size = 4
    val_batch_size = {bs}
    num_workers = 2
    quantize_args = dict(
        max_imgs=2, N=1000, split_method='event_count',
        convert_method='event_histogram', grayscale=True,
        count_non_zero=False, background_mask=True,
    )
    model = {model!r}
    clip_dict = dict(arch={arch!r}, prompt='a point cloud image of a {{}}',
                     agg_func='mean')
    d_model = 16
    adapter_dict = dict(adapter_type='text-trans', in_dim=32, d_model=16,
                        num_heads=2, ffn_dim=32, num_layers=1, residual=0.8)
"""


def write_config(path, dataset="n_caltech", model="ZSCLIP",
                 arch="ViT-T/8@32", bs=8):
    with open(path, "w") as f:
        f.write(CONFIG.format(dataset=dataset, model=model, arch=arch,
                              bs=bs))
    return str(path)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Trees, configs, a ViT-T/8@32 `.pt` and the merge table (on
    EVENTCLIP_BPE_PATH meanwhile)."""
    d = tmp_path_factory.mktemp("gen")
    vocab = str(d / "bpe.txt.gz")
    with gzip.open(vocab, "wt", encoding="utf-8") as f:
        f.write("#version: 0.2\n"
                + "\n".join(" ".join(m) for m in MERGES) + "\n")
    sd = random_clip_state_dict(
        np.random.default_rng(0), width=64, layers=2, patch=8, image=32,
        t_width=32, t_layers=2, vocab=49408, context=77, embed=32)
    pt = str(d / "clip.pt")
    torch.save({k: v.half() for k, v in sd.items()}, pt)
    out = {"d": d, "pt": pt, "sd": sd,
           "nc": make_tree(str(d / "nc")),
           "nin": make_nin_tree(str(d / "nin")),
           "zs": write_config(d / "zs.py"),
           "zs_nin": write_config(d / "zs_nin.py", dataset="n_imagenet")}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("EVENTCLIP_BPE_PATH", vocab)
        yield out


# -- the shared probabilities ------------------------------------------------


def _stat(windows, xp):
    """[..., V, N, 3] int16 windows -> [..., V] f32: the polarity-signed
    sum of x + 3y over each view's events, folded mod 997 (integers below
    2^24: exact in f32 on both sides)."""
    w = windows.astype(xp.float32) if xp is jnp else windows.float()
    s = ((w[..., 0] + 3.0 * w[..., 1]) * w[..., 2]).sum(-1)
    return (s - 997.0 * xp.floor(s / 997.0)) / 997.0


def _probs(stat, valid, n_cls, xp):
    v = valid.astype(xp.float32) if xp is jnp else valid.float()
    u = (stat * v).sum(-1) / v.sum(-1)
    c = xp.arange(n_cls, dtype=xp.float32)
    logits = 3.0 * xp.sin(2 * np.pi * (u[:, None] * (c + 1.0) + 0.37 * c))
    if xp is jnp:
        return jax.nn.softmax(logits, axis=-1)
    return torch.softmax(logits, dim=-1)


@contextlib.contextmanager
def shared_probabilities(monkeypatch, n_cls):
    """Both packages' rasterizer -> `_stat`, classifier forward (the
    port's teacher: its LocalSplit's forward, rasterizer included) ->
    `_probs`; the towers are built and unused, and so are the text
    features, which both packages take as zeros."""
    import eventclip_tpu.engine.trainer as jt
    import eventclip_tpu.models.classifier as jc
    import eventclip_tpu.ops.rasterize as jr

    monkeypatch.setattr(jt, "build_text_features",
                        lambda *a: jnp.zeros((n_cls, 32)))
    monkeypatch.setattr(gen_data, "build_text_features",
                        lambda *a: torch.zeros(n_cls, 32))

    monkeypatch.setattr(jr, "rasterize_for_clip",
                        lambda spec, pp, w, mesh=None: _stat(w, jnp))
    monkeypatch.setattr(jc, "classifier_forward",
                        lambda p, cfg, s, v, **kw: {
                            "probs": _probs(s, v, n_cls, jnp)})
    monkeypatch.setattr(gen_data, "rasterize_for_clip",
                        lambda spec, pp, w: _stat(w, torch))
    monkeypatch.setattr(gen_data.LocalSplit, "forward",
                        lambda self, cfg, spec, pp, w, v: {
                            "probs": _probs(_stat(w, torch), v, n_cls,
                                            torch)})
    yield


def _table(params, tta):
    """The port's [n, 4 (TTA) or 1, n_cls] probabilities of every
    training stream, in dataset order, and the dataset."""
    ds = build_dataset(params, val_only=False, gen_data=True, tta=tta)
    b = collate([ds[i] for i in range(len(ds))])
    w = torch.from_numpy(b["windows"])
    v = torch.from_numpy(b["valid_mask"])
    p = _probs(_stat(w.reshape((-1,) + w.shape[-3:]), torch),
               v.reshape((-1, v.shape[-1])), len(ds.classes), torch)
    return p.reshape(len(ds), -1, len(ds.classes)).numpy(), ds


def assert_at_gap(values, thresh):
    assert np.min(np.abs(np.asarray(values) - thresh)) > GAP, thresh


# -- running both CLIs ---------------------------------------------------------


def run_both(argv, save_dir, tag):
    """(port result, port report, JAX report, port tree, JAX tree)."""
    outs, trees = [], []
    res = None
    for who in ("port", "jax"):
        save = os.path.join(save_dir, f"{tag}-{who}")
        full = argv + ["--save_path", save]
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            if who == "port":
                res = gen_data.main(full + ["--cpu"])
            else:
                args = gen_data.parse_args(full)
                params = ref_load_params(args.params)
                if args.fp32:
                    params.bf16 = False
                if args.data_root:
                    params.data_root = args.data_root
                REF_GEN.main(params, args)
        out = buf.getvalue()
        outs.append(out[out.index("Class stats:"):
                        out.index("Pseudo-label dataset tree")])
        trees.append(tree_links(save))
    return res, outs[0], outs[1], trees[0], trees[1]


def tree_links(root):
    """{relative path: real path of a link, or 'dir'} under `root`."""
    out = {}
    for dp, dirs, fs in os.walk(root):
        for name in dirs + fs:
            p = os.path.join(dp, name)
            rel = os.path.relpath(p, root)
            out[rel] = os.path.realpath(p) if os.path.islink(p) else "dir"
    return out


def assert_same(port_out, jax_out, port_tree, jax_tree):
    assert port_out == jax_out
    assert port_tree == jax_tree
    for rel, real in port_tree.items():
        if real != "dir":
            assert os.path.exists(real), rel


def test_ncaltech_zs_tta_filters_topk_equal_root(files, monkeypatch):
    tree = files["nc"]
    params = ref_load_params(files["zs"])
    params.data_root = tree
    probs, ds = _table(params, tta=True)
    thresh = 0.45
    assert_at_gap(probs.mean(1).max(-1), thresh)
    assert_at_gap(probs.max(-1).min(-1), thresh)
    argv = ["--params", files["zs"], "--clip_ckpt", files["pt"],
            "--data_root", tree, "--fp32", "--conf_thresh", str(thresh),
            "--tta", "--tta_consistent", "--tta_min_prob", "--topk", "2"]
    with shared_probabilities(monkeypatch, len(ds.classes)):
        res, got, want, got_tree, want_tree = run_both(
            argv, str(files["d"]), "nc")
    assert_same(got, want, got_tree, want_tree)
    # the filters did filter: some streams dropped, some kept, by each
    pred = probs.argmax(-1)
    consistent = (pred == pred[:, :1]).all(-1)
    keep = consistent & (probs.max(-1).min(-1) > thresh) & (
        probs.mean(1).max(-1) > thresh)
    assert 0 < keep.sum() < len(keep) and not consistent.all()
    assert sum(res["sel"].values()) == len(res["path2cls"]) <= 2 * 3
    # each class's top-k cut sits at a gap too
    for c in range(len(ds.classes)):
        p = np.sort(probs.mean(1).max(-1)[keep & (probs.mean(1).argmax(-1)
                                                 == c)])[::-1]
        if len(p) > 2:
            assert p[1] - p[2] > GAP
    assert "Using topk=2" in got and "Select" in got


def test_nimagenet_zs_tta_equal_root(files, monkeypatch):
    tree = files["nin"]
    params = ref_load_params(files["zs_nin"])
    params.data_root = tree
    probs, ds = _table(params, tta=True)
    thresh = 0.4
    assert_at_gap(probs.mean(1).max(-1), thresh)
    argv = ["--params", files["zs_nin"], "--clip_ckpt", files["pt"],
            "--data_root", tree, "--fp32", "--conf_thresh", str(thresh),
            "--tta"]
    with shared_probabilities(monkeypatch, len(ds.classes)):
        _, got, want, got_tree, want_tree = run_both(
            argv, str(files["d"]), "nin")
    assert_same(got, want, got_tree, want_tree)
    assert got_tree["extracted_val"] == os.path.realpath(
        os.path.join(tree, "extracted_val"))
    wnids = sorted(os.listdir(os.path.join(tree, "extracted_train")))
    assert {r.split(os.sep)[1] for r in got_tree
            if r.startswith("extracted_train" + os.sep)} == set(wnids)


def _gt_tree(root):
    """A 101-class N-Caltech tree holding every file of the shipped 1-shot
    split, one more training stream a class and one testing stream."""
    from eventclip_tpu_torch.data.datasets import load_split_asset

    rng = np.random.default_rng(3)
    split = load_split_asset("NCaltech101", 1, True)

    def write(path):
        n = 1200 + int(rng.integers(0, 300))
        os.makedirs(os.path.dirname(path), exist_ok=True)
        np.save(path, np.stack([rng.integers(0, 240, n),
                                rng.integers(0, 180, n),
                                np.sort(rng.uniform(0, 0.3, n)),
                                rng.choice([-1.0, 1.0], n)], 1))

    for rel in split:
        cls, fn = rel.split("/")[-2:]
        write(os.path.join(root, "training", cls, fn))
        write(os.path.join(root, "training", cls, f"{cls}_x0.npy"))
        write(os.path.join(root, "testing", cls, f"{cls}_t0.npy"))
    return root, split


def test_fs_teacher_merges_gt_like_root(files, monkeypatch):
    """--weight (the JAX package's FS checkpoint of the teacher) with
    --gt_shots 1: the GT files are not pseudo-labelled, and every one is
    linked under its original folder, first-match rename inversion
    included (both Faces and Faces_easy rename to 'face': Faces/)."""
    d = files["d"]
    tree, split = _gt_tree(str(d / "nc101"))
    cfg = write_config(d / "fs.py", model="FSCLIP")
    params = ref_load_params(cfg)
    params.data_root = tree
    probs, ds = _table(params, tta=False)
    thresh = 0.5
    assert_at_gap(probs[:, 0].max(-1), thresh)
    ref_cfg = ref_classifier.build_classifier_config(params,
                                                     ref_arch("ViT-T/8@32"))
    clip = jax.tree_util.tree_map(
        jnp.asarray, ref_convert.convert_clip_state_dict(files["sd"]))
    teacher = ref_classifier.init_classifier_params(
        jax.random.PRNGKey(1), ref_cfg, clip_params=clip,
        n_classes=len(ds.classes))
    weight = str(d / "fs-1shot" / "best.npz")
    os.makedirs(os.path.dirname(weight))
    ref_ckpt.save_trainable(weight, ref_cfg, teacher)
    argv = ["--params", cfg, "--clip_ckpt", files["pt"], "--data_root",
            tree, "--fp32", "--conf_thresh", str(thresh), "--weight", weight,
            "--gt_shots", "1"]
    with shared_probabilities(monkeypatch, len(ds.classes)):
        res, got, want, got_tree, want_tree = run_both(
            argv, str(d), "pseudo-1shot")
    assert_same(got, want, got_tree, want_tree)
    inverted = {"Faces_easy": "Faces"}
    for rel in split:
        cls, fn = rel.split("/")[-2:]
        link = os.path.join("training", inverted.get(cls, cls), fn)
        assert got_tree[link] == os.path.realpath(
            os.path.join(tree, "training", cls, fn))
    assert not any(os.path.basename(p) in {r.split("/")[-1] for r in split}
                   for p in res["path2cls"])
    assert os.path.join("training", "Faces_easy") not in got_tree


def test_int8_calibrated_pruned_teacher_equals_root(files):
    """The real ViT-T/8@32 forward, W8A8 with static scales from the first
    batch (val_batch_size 8: one batch on both sides) and 8 of 16
    patches kept."""
    argv = ["--params", files["zs"], "--clip_ckpt", files["pt"],
            "--data_root", files["nc"], "--fp32", "--conf_thresh", "0.5",
            "--int8", "--int8_calib", "1", "--prune_tokens", "8"]
    res, got, want, got_tree, want_tree = run_both(
        argv, str(files["d"]), "int8")
    assert_same(got, want, got_tree, want_tree)
    assert res["stats"]["samples"] == 18


def test_resnet_teacher_equals_root(files, monkeypatch):
    """An RN-T@32 teacher, the real forward in f32: towers from one
    `.npz` (chip_smoke's OpenAI-layout export of random towers, converted
    by the JAX package); RN-T@32's 128-id text tower cannot embed the BPE
    ids, so both packages get the same normalized text features."""
    d = files["d"]
    clip = model.init_clip_params(clip_arch_config("RN-T@32"),
                                  torch.Generator().manual_seed(4))
    sd = chip_smoke.openai_state_dict(clip)
    npz = str(d / "rn.npz")
    np.savez(npz, **_flat(ref_convert.convert_clip_state_dict(sd)))
    feats = np.random.default_rng(2).normal(size=(3, 32)).astype(np.float32)
    feats /= np.linalg.norm(feats, axis=-1, keepdims=True)
    import eventclip_tpu.engine.trainer as jt

    monkeypatch.setattr(jt, "build_text_features",
                        lambda *a, **k: jnp.asarray(feats))
    monkeypatch.setattr(gen_data, "build_text_features",
                        lambda *a, **k: torch.from_numpy(feats))
    init = ref_model.init_clip_params
    # the JAX .npz route reads only a random tree's structure and shapes
    monkeypatch.setattr(ref_model, "init_clip_params", lambda rng, cfg: (
        jax.tree_util.tree_map(lambda a: np.zeros(a.shape, a.dtype),
                               jax.eval_shape(lambda r: init(r, cfg),
                                              rng))))
    cfg = write_config(d / "rn.py", arch="RN-T@32")
    argv = ["--params", cfg, "--clip_ckpt", npz, "--data_root", files["nc"],
            "--fp32", "--conf_thresh", "0.5", "--tta"]
    _, got, want, got_tree, want_tree = run_both(argv, str(d), "rn")
    assert_same(got, want, got_tree, want_tree)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        elif v is not None:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def test_filter_functions_on_a_table(tmp_path, capsys):
    """filter_batch / topk_refilter / report_selection on hand-made
    probabilities: TTA consistency and min-prob masks, padding rows and GT
    files skipped, top-k by numpy's argsort over selection order."""
    names = ["a", "b"]
    s = gen_data.Selection(names)
    probs = np.array([
        [[.9, .1], [.8, .2], [.95, .05], [.7, .3]],   # kept: a
        [[.9, .1], [.2, .8], [.9, .1], [.9, .1]],     # inconsistent
        [[.2, .8], [.1, .9], [.45, .55], [.1, .9]],   # min prob .55 < .6
        [[.1, .9], [.1, .9], [.1, .9], [.1, .9]],     # GT file: skipped
        [[.3, .7], [.3, .7], [.3, .7], [.3, .7]],     # kept: b
        [[.9, .1], [.9, .1], [.9, .1], [.9, .1]],     # padding row
    ], np.float32)
    paths = ["r/a/0.npy", "r/a/1.npy", "r/b/2.npy", "r/b/3.npy",
             "r/b/4.npy", "r/b/4.npy"]
    gen_data.filter_batch(
        s, probs, np.array([0, 0, 1, 1, 0, 0]),
        np.array([1, 1, 1, 1, 1, 0], bool), paths, {"b/3.npy"}, tta=True,
        tta_consistent=True, tta_min_prob=True, conf_thresh=0.6, topk=1)
    assert s.n_total == 5 and s.n_correct == 4  # the GT file counts here
    assert s.sel == {"a": 1, "b": 1} and s.correct == {"a": 1, "b": 0}
    assert s.path2cls == {"r/a/0.npy": {"cls": "a", "prob": pytest.approx(
        0.8375)}, "r/b/4.npy": {"cls": "b", "prob": pytest.approx(0.7)}}
    table = {"x/a/0": {"cls": "a", "prob": .5}, "x/b/1": {"cls": "a",
                                                          "prob": .9},
             "x/a/2": {"cls": "a", "prob": .5}}
    out, sel, cor = gen_data.topk_refilter(
        table, names, 2, lambda p: p.split("/")[1])
    assert out == {"x/b/1": "a", "x/a/0": "a"} and sel == {"a": 2, "b": 0}
    assert cor == {"a": 1, "b": 0}


def test_multi_host_and_int8_resnet_are_refused(files, monkeypatch):
    # multi-host runs are ported (test_two_ranks_label_like_one_process);
    # int8 on a ResNet teacher stays refused
    cfg = write_config(files["d"] / "rn_int8.py", arch="RN-T@32")
    monkeypatch.setattr(gen_data, "build_text_features",
                        lambda *a, **k: torch.eye(3, 32))
    with pytest.raises(SystemExit, match="--int8: int8 quantization "
                       "supports the ViT towers only"):
        gen_data.main(["--params", cfg, "--cpu", "--smoke", "--fp32",
                       "--data_root", files["nc"], "--int8"])


def report(out):
    return out[out.index("Class stats:"):out.index("Pseudo-label dataset tree")]


@pytest.mark.parametrize("flags", [
    ["--tta", "--tta_consistent", "--conf_thresh", "0.5"],
    ["--conf_thresh", "0.5", "--int8", "--int8_calib", "1"],
], ids=["tta", "int8-calib"])
def test_two_ranks_label_like_one_process(files, tmp_path, flags):
    """Batches of 8 (TTA: 2) split over 2 ranks, the last one leaving
    rank 1 no stream; each rank calibrates on its shard and the max-abs
    is folded over both, so the teacher is the one process's."""
    from .test_torch_cli import launch_env
    from .test_torch_parallel import spawn_ranks

    argv = ["--params", files["zs"], "--clip_ckpt", files["pt"],
            "--data_root", files["nc"], "--fp32", "--cpu"] + flags
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        gen_data.main(argv + ["--save_path", str(tmp_path / "one")])
    want = report(buf.getvalue())
    outs = spawn_ranks("tests.torch_ddp_worker",
                       ["gen_data"] + argv + ["--save_path",
                                              str(tmp_path / "two")],
                       env_of=launch_env("jax"))
    for rank, (rc, log) in enumerate(outs):
        assert rc == 0, log
        assert f"SHARD {rank} 2" in log, log
    assert report(outs[0][1]) == want
    assert "Class stats:" not in outs[1][1]
    assert "Select " in want
    assert tree_links(str(tmp_path / "two")) == \
        tree_links(str(tmp_path / "one"))
