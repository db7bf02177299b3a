"""The port's serving options vs the JAX package's: `weight=` (FS and FT,
`.npz` and `.pth`), int8 (dynamic and calibrated), token pruning,
embeddings, label swaps, StreamSession, load_event_file and the serve CLI.

The JAX Predictor's random towers and text features cross to the port as
numpy; checkpoints are written by the JAX package. Every comparison runs
f32 (`bf16 = False`), where the float paths agree to atol 1e-5 on
probabilities (tests/test_torch_serve.py). Tolerances, and why:

- float paths (weight=, pruning, set_classes, StreamSession, the CLI):
  probabilities atol 1e-5, labels and top-k equal;
- int8 paths: probabilities atol 1e-4, labels equal (the int32 sums are
  exact; XLA may evaluate `x / ax` as `x * rcp(ax)`, moving an activation
  on a .5 boundary by one quantum, tests/test_torch_quant.py);
- embeddings: rtol 1e-5, atol 1e-6 (unit vectors, f32); on the int8
  paths ||port - JAX|| <= 1e-3 a row (the same code flips);
- windows, decoded files: bit-equal.
"""

import gzip
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from eventclip_tpu.engine.checkpoint import save_trainable as ref_save
from eventclip_tpu.engine.checkpoint import load_checkpoint as ref_load
from eventclip_tpu.models import classifier as ref_cls
from eventclip_tpu.models.clip.config import clip_arch_config as ref_arch
from eventclip_tpu import serve as ref_serve
from eventclip_tpu.utils.config import Params
from eventclip_tpu.utils.config import load_params as ref_load_params
from eventclip_tpu_torch import serve
from eventclip_tpu_torch.models.clip.convert_method import (
    save_method_checkpoint, unflatten)
from eventclip_tpu_torch.utils.config import load_params

from .test_e2e import make_tree
from .test_tokenizer import MERGES
from .torch_oracle import random_clip_state_dict

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ZS = os.path.join(ROOT, "configs/debug/zsclip_tiny_params.py")
FS = os.path.join(ROOT, "configs/debug/fsclip_tiny_params.py")
NAMES = ["airplanes", "ant", "brain", "camera", "dolphin"]
ARCH = "ViT-T/8@32"


class _TinyFT(Params):
    """A tiny FT config: the whole visual tower and the prompts train."""
    dataset = "n_caltech"
    data_root = "/nonexistent"
    val_batch_size = 4
    quantize_args = dict(
        max_imgs=2, N=1000, split_method="event_count",
        convert_method="event_histogram", grayscale=True,
        count_non_zero=False, background_mask=True,
    )
    model = "FTCLIP"
    clip_dict = dict(arch=ARCH, prompt="a point cloud image of a {}",
                     agg_func="mean")
    adapter_dict = dict(adapter_type="text-identity")
    bf16 = False


def _streams(seed, lengths=(600, 2800, 4100, 13700, 900)):
    rng = np.random.default_rng(seed)
    out = []
    for n in lengths:  # 1 .. >10 views of 1000
        out.append(np.stack([
            rng.integers(0, 240, n), rng.integers(0, 180, n),
            np.sort(rng.uniform(0, 0.3, n)), rng.choice([-1.0, 1.0], n),
        ], axis=1).astype(np.float32))
    return out


def _params(path_or_cls, port):
    if isinstance(path_or_cls, str):
        p = (load_params if port else ref_load_params)(path_or_cls)
    else:
        p = path_or_cls()
    p.bf16 = False
    return p


@pytest.fixture(scope="module")
def towers():
    """The JAX smoke Predictor's towers and text features, as numpy."""
    ref = ref_serve.Predictor(_params(ZS, False), NAMES, smoke=True,
                              batch_size=4)
    return (jax.tree_util.tree_map(np.asarray, ref._params["clip"]),
            np.asarray(ref._params["text_feats"]), ref)


def _port(towers, config=ZS, **kw):
    tree, tf, _ = towers
    return serve.Predictor(_params(config, True), NAMES, clip_params=tree,
                           text_feats=tf, batch_size=4, device="cpu", **kw)


def _same(got, want, atol=1e-5):
    np.testing.assert_allclose(got["probs"], want["probs"], atol=atol,
                               rtol=0)
    np.testing.assert_array_equal(got["label"], want["label"])
    assert got["names"] == want["names"]


def _same_embed(port, ref, streams, int8=False):
    """The random towers' ZS probabilities are nearly one-hot (logit scale
    100), so the per-stream features (embed=True on both) carry the
    comparison: unit vectors, rtol 1e-5 and atol 1e-6 on the float paths;
    on the int8 paths ||port - JAX|| <= 1e-3 for each (unit) row."""
    got, want = port.embed(streams), ref.embed(streams)
    if int8:
        assert np.linalg.norm(got - want, axis=-1).max() <= 1e-3
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    return got


# -- weight= -----------------------------------------------------------------


def _checkpoint(tmp_path, config, towers, fmt):
    """A trained-looking checkpoint written by the JAX package: every
    trainable leaf perturbed from its init, saved as .npz (then, for
    .pth, exported to the reference's layout)."""
    tree, tf, _ = towers
    params = _params(config, False)
    cfg = ref_cls.build_classifier_config(params, ref_arch(ARCH),
                                          dtype=jnp.float32)
    full = ref_cls.init_classifier_params(
        jax.random.PRNGKey(5), cfg,
        clip_params=jax.tree_util.tree_map(jnp.asarray, tree),
        text_feats=jnp.asarray(tf))
    rng = np.random.default_rng(9)
    full = jax.tree_util.tree_map(
        lambda a: jnp.asarray(np.asarray(a) + 0.05 * rng.normal(
            size=a.shape).astype(np.float32)), full)
    path = str(tmp_path / "best.npz")
    ref_save(path, cfg, full)
    if fmt == "pth":
        flat, _ = ref_load(path)
        path = str(tmp_path / "best.pth")
        save_method_checkpoint(path, unflatten(flat))
    return path


@pytest.mark.parametrize("fmt", ["npz", "pth"])
@pytest.mark.parametrize("config", [FS, _TinyFT], ids=["FS", "FT"])
def test_weight_serves_like_jax(towers, tmp_path, config, fmt):
    tree, tf, _ = towers
    weight = _checkpoint(tmp_path, config, towers, fmt)
    # the JAX Predictor starts from the same smoke towers
    ref = ref_serve.Predictor(_params(config, False), NAMES, weight=weight,
                              smoke=True, batch_size=4, embed=True)
    port = _port(towers, config, weight=weight, embed=True)
    got = port.predict(_streams(0), top_k=3)
    want = ref.predict(_streams(0), top_k=3)
    _same(got, want)
    np.testing.assert_array_equal(got["topk"], want["topk"])
    feats = _same_embed(port, ref, _streams(0))
    # the checkpoint changed the features (it was loaded, not ignored)
    zs = _port(towers, embed=True).embed(_streams(0))
    assert np.abs(feats - zs).max() > 1e-2


@pytest.mark.parametrize("config", [FS, _TinyFT], ids=["FS", "FT"])
def test_trainable_model_without_weight_is_refused(towers, config):
    with pytest.raises(ValueError, match="trainable weights") as port_err:
        _port(towers, config)
    with pytest.raises(ValueError, match="trainable weights") as ref_err:
        ref_serve.Predictor(_params(config, False), NAMES, smoke=True)
    assert str(port_err.value) == str(ref_err.value)


# -- int8, pruning -------------------------------------------------------------


@pytest.mark.parametrize("calibrated", [False, True],
                         ids=["dynamic", "calibrated"])
def test_int8_serves_like_jax(towers, calibrated):
    calib = _streams(1, (2500, 3100, 4000, 3300)) if calibrated else None
    ref = ref_serve.Predictor(_params(ZS, False), NAMES, smoke=True,
                              batch_size=4, int8=True,
                              int8_calib_streams=calib, embed=True)
    port = _port(towers, int8=True, int8_calib_streams=calib, embed=True)
    _same(port.predict(_streams(2)), ref.predict(_streams(2)), atol=1e-4)
    feats = _same_embed(port, ref, _streams(2), int8=True)
    full = _port(towers, embed=True).embed(_streams(2))
    assert np.abs(feats - full).max() > 1e-4  # a quantized forward


@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
def test_pruned_serving_matches_jax(towers, int8):
    kw = dict(prune_tokens=8, int8=int8, embed=True)
    ref = ref_serve.Predictor(_params(ZS, False), NAMES, smoke=True,
                              batch_size=4, **kw)
    port = _port(towers, **kw)
    atol = 1e-4 if int8 else 1e-5
    _same(port.predict(_streams(3)), ref.predict(_streams(3)), atol=atol)
    feats = _same_embed(port, ref, _streams(3), int8=int8)
    # 8 of 16 patches: other features than the full sequence's
    full = _port(towers, embed=True).embed(_streams(3))
    assert np.abs(feats - full).max() > 1e-3


# -- embeddings -----------------------------------------------------------------


@pytest.mark.parametrize("tta", [False, True], ids=["plain", "tta"])
def test_embed_matches_jax(towers, tta):
    ref = ref_serve.Predictor(_params(ZS, False), NAMES, smoke=True,
                              batch_size=4, embed=True, tta=tta)
    port = _port(towers, embed=True, tta=tta)
    streams = _streams(4)  # 5 streams: a padded second chunk at bs 4
    got, want = port.embed(streams), ref.embed(streams)
    assert got.shape == (5, 32) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-5)
    # content-addressed: a stream's embedding does not depend on its row
    np.testing.assert_allclose(port.embed([streams[1], streams[0]]),
                               got[[1, 0]], rtol=1e-5, atol=1e-6)
    assert port.embed([]).shape == (0, 32)
    port.warm_up()  # covers the embed program too


def test_embed_requires_opt_in(towers):
    with pytest.raises(RuntimeError, match="embed=True"):
        _port(towers).embed(_streams(5, (1500,)))


# -- label swaps -----------------------------------------------------------------


@pytest.fixture
def vocab(tmp_path, monkeypatch):
    path = tmp_path / "bpe.txt.gz"
    with gzip.open(path, "wt", encoding="utf-8") as f:
        f.write("#version: 0.2\n"
                + "\n".join(" ".join(m) for m in MERGES) + "\n")
    monkeypatch.setenv("EVENTCLIP_BPE_PATH", str(path))


def test_set_classes_matches_jax_and_swaps_back_exactly(towers, vocab):
    ref = ref_serve.Predictor(_params(ZS, False), NAMES, smoke=True,
                              batch_size=4)
    port = _port(towers)
    streams = _streams(6)
    new = ["cup", "chair", "lamp"]
    for names in (NAMES, new):
        ref.set_classes(names)
        port.set_classes(names)
        np.testing.assert_allclose(
            port._params.text_feats.detach().numpy(),
            np.asarray(ref._params["text_feats"]), rtol=2e-4, atol=2e-5)
        got = port.predict(streams)
        _same(got, ref.predict(streams))
        assert got["probs"].shape == (5, len(names))
        if names is NAMES:
            first = got
    port.set_classes(NAMES)
    again = port.predict(streams)
    np.testing.assert_array_equal(again["probs"], first["probs"])
    with pytest.raises(ValueError, match="non-empty"):
        port.set_classes([])


def test_set_classes_refuses_prompt_tuned(towers, tmp_path):
    port = _port(towers, FS, weight=_checkpoint(tmp_path, FS, towers, "npz"))
    with pytest.raises(ValueError, match="prompt-tunes"):
        port.set_classes(["x", "y"])


# -- StreamSession ---------------------------------------------------------------


def test_stream_session_equals_predict_and_jax(towers):
    tree, tf, ref = towers
    port = _port(towers)
    stream = _streams(7, (4100,))[0]
    sess, ref_sess = serve.StreamSession(port), ref_serve.StreamSession(ref)
    n = 0
    for chunk in np.array_split(stream, 4):
        n = sess.append(chunk)
        ref_sess.append(chunk)
    sess.append(np.empty((0, 4)))
    sess.append([])  # a quiet interval from a JSON decoder
    assert n == sess.n_events == len(stream)
    got = sess.predict(top_k=2)
    want = port.predict([stream], top_k=2)
    assert got["label"] == int(want["label"][0])
    assert got["name"] == want["names"][0]
    np.testing.assert_array_equal(got["probs"], want["probs"][0])
    np.testing.assert_array_equal(got["topk"], want["topk"][0])
    assert got["n_events"] == len(stream)
    ref_got = ref_sess.predict(top_k=2)
    np.testing.assert_allclose(got["probs"], ref_got["probs"], atol=1e-5,
                               rtol=0)
    assert got["label"] == ref_got["label"]


def test_stream_session_ring_buffer_equals_jax():
    """Adversarial chunkings (empty, larger than the horizon, exact
    boundaries): after every append both sessions buffer the same last
    `horizon` events."""

    class _Stub:
        views, window = 4, 50

    r = np.random.default_rng(0)
    sess = serve.StreamSession(_Stub(), horizon=200)
    ref = ref_serve.StreamSession(_Stub(), horizon=200)
    everything = []
    for _ in range(60):
        n = int(r.choice([0, 1, 7, 50, 199, 200, 201, 520]))
        chunk = r.normal(size=(n, 4)).astype(np.float32)
        assert sess.append(chunk) == ref.append(chunk)
        everything.append(chunk)
        want = np.concatenate(everything)[-200:]
        np.testing.assert_array_equal(sess.events(), want)
        np.testing.assert_array_equal(sess.events(), ref.events())
    sess.reset()
    assert sess.n_events == 0 and sess.events().shape == (0, 4)


def test_stream_session_validation(towers):
    port = _port(towers)
    sess = serve.StreamSession(port)
    assert sess.horizon == port.views * port.window
    with pytest.raises(ValueError, match="empty session"):
        sess.predict()
    with pytest.raises(ValueError, match="x/y/t/p"):
        sess.append(np.zeros((5, 3)))
    with pytest.raises(ValueError, match="horizon"):
        serve.StreamSession(port, horizon=port.window - 1)


# -- load_event_file ---------------------------------------------------------------


def test_load_event_file_layouts_equal_jax(tmp_path):
    rng = np.random.default_rng(8)
    plain = _streams(8, (500,))[0].astype(np.float64)
    rec = np.zeros(400, dtype=[("x", "<u2"), ("y", "<u2"), ("t", "<i8"),
                               ("p", "?")])
    rec["x"] = rng.integers(0, 640, 400)
    rec["y"] = rng.integers(0, 480, 400)
    rec["t"] = np.sort(rng.integers(0, 10 ** 9, 400))
    rec["p"] = rng.integers(0, 2, 400).astype(bool)
    files = {"a.npy": lambda p: np.save(p, plain),
             "b.npz": lambda p: np.savez(p, event_data=rec),
             "c.npz": lambda p: np.savez(p, anything=plain)}
    for name, write in files.items():
        path = str(tmp_path / name)
        write(path)
        got = serve.load_event_file(path)
        assert got.dtype == np.float32 and got.shape[1] == 4
        np.testing.assert_array_equal(got, ref_serve.load_event_file(path))
    bad = str(tmp_path / "bad.npz")
    np.savez(bad, a=plain, b=plain)
    with pytest.raises(ValueError, match="unrecognized npz layout"):
        serve.load_event_file(bad)


# -- the serve CLI -------------------------------------------------------------


@pytest.fixture(scope="module")
def cli_files(tmp_path_factory):
    """A synthetic tree, a tiny fp16 `.pt`, a merge table (on
    EVENTCLIP_BPE_PATH meanwhile) and an f32 copy of the tiny ZS config."""
    import torch

    d = tmp_path_factory.mktemp("serve_cli")
    tree = make_tree(str(d / "tree"))
    vocab = str(d / "bpe.txt.gz")
    with gzip.open(vocab, "wt", encoding="utf-8") as f:
        f.write("#version: 0.2\n"
                + "\n".join(" ".join(m) for m in MERGES) + "\n")
    sd = random_clip_state_dict(
        np.random.default_rng(1), width=64, layers=2, patch=8, image=32,
        t_width=32, t_layers=2, vocab=49408, context=77, embed=32)
    pt = str(d / "clip.pt")
    torch.save({k: v.half() for k, v in sd.items()}, pt)
    with open(ZS) as f:
        text = f.read()
    config = str(d / "zs_f32_params.py")
    with open(config, "w") as f:
        f.write(text.replace("class EventCLIPParams(Params):",
                             "class EventCLIPParams(Params):\n    bf16 = False"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("EVENTCLIP_BPE_PATH", vocab)
        yield tree, pt, config


def _jsonl(path):
    import json

    with open(path) as f:
        return [json.loads(ln) for ln in f]


def test_serve_cli_jsonl_equals_jax(cli_files, tmp_path):
    tree, pt, config = cli_files
    argv = ["--params", config, "--inputs", f"{tree}/testing/**/*.npy",
            "--data_root", tree, "--clip_ckpt", pt, "--batch_size", "4",
            "--top_k", "2", "--probs", "--cpu"]
    serve.main(argv + ["--out", str(tmp_path / "port.jsonl")])
    ref_serve.main(argv + ["--out", str(tmp_path / "jax.jsonl")])
    got, want = _jsonl(tmp_path / "port.jsonl"), _jsonl(tmp_path / "jax.jsonl")
    assert len(got) == len(want) == 12
    for g, w in zip(got, want):
        assert {k: g[k] for k in ("path", "label", "name", "topk",
                                  "topk_names")} == \
            {k: w[k] for k in ("path", "label", "name", "topk", "topk_names")}
        np.testing.assert_allclose(g["probs"], w["probs"], atol=1e-5, rtol=0)


def test_serve_cli_embed_out_equals_jax(cli_files, tmp_path):
    tree, pt, config = cli_files
    argv = ["--params", config, "--inputs", f"{tree}/testing/**/*.npy",
            "--data_root", tree, "--clip_ckpt", pt, "--batch_size", "4",
            "--cpu"]
    serve.main(argv + ["--embed_out", str(tmp_path / "port.npz")])
    ref_serve.main(argv + ["--embed_out", str(tmp_path / "jax.npz")])
    with np.load(tmp_path / "port.npz") as g, \
            np.load(tmp_path / "jax.npz") as w:
        np.testing.assert_array_equal(g["paths"], w["paths"])
        assert g["embeddings"].shape == (12, 32)
        np.testing.assert_allclose(g["embeddings"], w["embeddings"],
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(np.linalg.norm(g["embeddings"], axis=-1),
                                   1.0, atol=1e-5)


def test_serve_cli_from_export_equals_jax(cli_files, tmp_path):
    """`--from_export` is ported: the port's serve CLI over a bundle of
    the port's Predictor writes the JSONL the JAX CLI writes from the
    same config, towers and tree (tests/test_torch_export.py covers the
    bundles themselves)."""
    from eventclip_tpu_torch.export import export_predictor

    tree, pt, config = cli_files
    bundle = str(tmp_path / "model.eclip")
    pred = serve.Predictor(_params(config, True), serve.resolve_class_names(
        _params(config, True), data_root=tree), clip_ckpt=pt, batch_size=32,
        device="cpu", pack_views=False)
    export_predictor(pred, bundle)
    inputs = ["--inputs", f"{tree}/testing/**/*.npy", "--top_k", "2"]
    serve.main(["--from_export", bundle, "--out", str(tmp_path / "p.jsonl"),
                "--cpu"] + inputs)
    ref_serve.main(["--params", config, "--data_root", tree, "--clip_ckpt",
                    pt, "--out", str(tmp_path / "j.jsonl"), "--cpu"]
                   + inputs)
    got, want = _jsonl(tmp_path / "p.jsonl"), _jsonl(tmp_path / "j.jsonl")
    assert [r["path"] for r in got] == [r["path"] for r in want]
    assert [r["topk_names"] for r in got] == [r["topk_names"]
                                              for r in want]


# -- ResNet towers --------------------------------------------------------------


def test_resnet_predictor_matches_jax(tmp_path, monkeypatch):
    """A ZS Predictor on RN-T@32 towers (one `.npz` for both packages),
    with `prune_tokens` set (a ResNet ignores it) and the text features a
    shared function of the label set (RN-T@32's 128-id text tower cannot
    embed BPE ids): predict, embed (f32 tolerances above) and a label swap
    equal the JAX Predictor's; int8 is refused with the JAX package's
    ValueError."""
    import zlib

    import torch

    import eventclip_tpu.engine.trainer as ref_trainer
    import eventclip_tpu.models.clip.model as ref_model
    from eventclip_tpu_torch.models.clip import convert, model
    from eventclip_tpu_torch.models.clip.config import clip_arch_config

    clip = model.init_clip_params(clip_arch_config("RN-T@32"),
                                  torch.Generator().manual_seed(7))
    npz = str(tmp_path / "rn.npz")
    np.savez(npz, **convert.to_jax_flat(clip.named_parameters()))

    def feats_of(names):
        rng = np.random.default_rng(zlib.crc32(" ".join(names).encode()))
        f = rng.normal(size=(len(names), 32)).astype(np.float32)
        return f / np.linalg.norm(f, axis=-1, keepdims=True)

    monkeypatch.setattr(ref_trainer, "build_text_features",
                        lambda c, cfg, names, *a: jnp.asarray(
                            feats_of(names)))
    monkeypatch.setattr(serve, "build_text_features",
                        lambda c, cfg, names, *a: torch.from_numpy(
                            feats_of(names)))
    init = ref_model.init_clip_params
    # the JAX .npz route reads only a random tree's structure and shapes
    monkeypatch.setattr(ref_model, "init_clip_params", lambda rng, cfg: (
        jax.tree_util.tree_map(lambda a: np.zeros(a.shape, a.dtype),
                               jax.eval_shape(lambda r: init(r, cfg),
                                              rng))))
    p, ref_p = _params(ZS, True), _params(ZS, False)
    p.clip_dict["arch"] = ref_p.clip_dict["arch"] = "RN-T@32"
    kw = dict(clip_ckpt=npz, batch_size=4, embed=True, prune_tokens=8)
    ref = ref_serve.Predictor(ref_p, NAMES, **kw)
    port = serve.Predictor(p, NAMES, device="cpu", **kw)
    streams = _streams(8)
    got = port.predict(streams)
    _same(got, ref.predict(streams))
    assert 0.05 < got["probs"].max(-1).min() < 0.999  # not one-hot
    _same_embed(port, ref, streams)
    for names in (["cup", "chair", "lamp"], NAMES):
        port.set_classes(names)
        ref.set_classes(names)
        _same(port.predict(streams), ref.predict(streams))
    for make in (lambda: serve.Predictor(p, NAMES, device="cpu", int8=True,
                                         clip_ckpt=npz),
                 lambda: ref_serve.Predictor(ref_p, NAMES, int8=True,
                                             clip_ckpt=npz)):
        with pytest.raises(ValueError, match="ViT towers only"):
            make()
