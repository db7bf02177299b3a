"""Frozen serving bundles (eventclip_tpu_torch/export.py) vs the port's
live Predictor and vs the JAX package's bundles.

The JAX smoke Predictor's towers and text features cross to the port
(f32, tests/test_server.py's `_TinyZS`: ViT-T/8@32, 10 views of 1000
events, batch 4, 3 classes). Every bundle kind is held to the live port
Predictor on the same streams, probabilities atol 1e-5 (the rule of
tests/test_torch_serve.py), labels and top-k equal: the padded and packed
programs (their graphs keep the `eventclip::` ops, which run their plain
versions on the CPU), TTA, int8, embeddings (atol 1e-5) and the offline
label swap. Against the JAX package's `ExportedPredictor` on the same
weights and streams: atol 1e-5 on the float paths; int8 atol 1e-4 with
labels equal and embeddings within 1e-3 a row (tests/test_torch_serve_options.py:
XLA may move an activation on a .5 boundary by one quantum). The JAX
tests' layout, host-contract, format and byte-order cases run against the
port, and each package's loader refuses the other's bundle.
"""

import gzip
import io
import json
import zipfile
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from eventclip_tpu.export import ExportedPredictor as RefExported
from eventclip_tpu.export import export_predictor as ref_export
from eventclip_tpu.serve import Predictor as RefPredictor
from eventclip_tpu_torch import serve
from eventclip_tpu_torch.export import ExportedPredictor, export_predictor

from .test_export import _TinyZS as _RefTinyZS
from .test_export import NAMES, _streams
from .test_tokenizer import MERGES
from .test_torch_server import _TinyZS


def _vocab(path):
    with gzip.open(path, "wt", encoding="utf-8") as f:
        f.write("#version: tiny\n"
                + "\n".join(f"{a} {b}" for a, b in MERGES))
    return str(path)


@pytest.fixture(scope="module")
def vocab(tmp_path_factory):
    """A BPE merge table on EVENTCLIP_BPE_PATH for the whole module: the
    bundles below freeze the text program and ship the table."""
    mp = pytest.MonkeyPatch()
    mp.setenv("EVENTCLIP_BPE_PATH", _vocab(
        tmp_path_factory.mktemp("vocab") / "bpe_simple_vocab_16e6.txt.gz"))
    yield
    mp.undo()


def _port(ref, towers=None, **kw):
    """A port Predictor on the JAX predictor's text features and float
    towers (those of `towers` when ref's are quantized)."""
    tree = jax.tree_util.tree_map(np.asarray,
                                  (towers or ref)._params["clip"])
    return serve.Predictor(_TinyZS(), NAMES, clip_params=tree,
                           text_feats=np.asarray(ref._params["text_feats"]),
                           batch_size=4, device="cpu", **kw)


def _small(**kw):
    """A padded-only smoke Predictor: a bundle of one program."""
    return serve.Predictor(_TinyZS(), NAMES, smoke=True, batch_size=4,
                           device="cpu", pack_views=False, **kw)


@pytest.fixture(scope="module")
def bundles(vocab, tmp_path_factory):
    """Live port and JAX predictors (embeddings on), the JAX bundle, and
    the port's bundle (padded, 4 packed, text and embed programs) of the
    same weights."""
    d = tmp_path_factory.mktemp("bundles")
    ref = RefPredictor(_RefTinyZS(), class_names=NAMES, smoke=True,
                       batch_size=4, embed=True)
    port = _port(ref, embed=True)
    path = str(d / "port.eclip")
    out = {"ref": ref, "port": port, "dir": d,
           "bundle": (path, export_predictor(port, path))}
    out["jax"] = str(d / "jax.eclip")
    ref_export(ref, out["jax"])
    out["jax_loaded"] = RefExported(out["jax"])  # its labels stay NAMES
    return out


@pytest.fixture(scope="module")
def frozen(bundles):
    """The port's bundle loaded once on the CPU; a test that changes it
    puts back what it changed."""
    return ExportedPredictor(bundles["bundle"][0], device="cpu")


def _long_streams(seed):
    """5 streams at batch 4 (a padded second chunk) and one long enough to
    take the content-seeded view subsampling."""
    rng = np.random.default_rng(seed)
    streams = _streams(rng, n=5)
    k = 14000
    streams[1] = np.stack([
        rng.integers(0, 240, k), rng.integers(0, 180, k),
        np.sort(rng.uniform(0, 0.3, k)), rng.choice([-1.0, 1.0], k),
    ], axis=1)
    return streams


def _same(got, want, atol=1e-5):
    np.testing.assert_allclose(got["probs"], want["probs"], atol=atol,
                               rtol=0)
    np.testing.assert_array_equal(got["label"], want["label"])
    assert got["names"] == want["names"]


def test_bundle_layout(bundles):
    (path, meta), port = bundles["bundle"], bundles["port"]
    with zipfile.ZipFile(path) as z:
        names = set(z.namelist())
        stored = json.loads(z.read("meta.json").decode("utf-8"))
        weights = z.getinfo("params.bin")
        programs = {n: z.read(n) for n in names if n.endswith(".pt2")}
    buckets = list(port._buckets or [])
    assert stored == meta and stored["buckets"] == buckets
    assert names == ({"meta.json", "params.bin", "step.pt2",
                      "text.pt2", "embed.pt2", "bpe_vocab.bin"}
                     | {f"packed_{k}.pt2" for k in buckets})
    assert stored["format"] == "eventclip_tpu_torch"
    assert stored["text"]["n_cls"] == len(NAMES) and stored["embed"]
    assert (stored["class_names"], stored["batch_size"],
            stored["window"], stored["views"], stored["tta"]) == (
                NAMES, 4, 1000, 10, False)
    assert stored["platforms"] == ["cpu"]
    # the weights once, STORED, as raw bytes of every leaf in order
    assert weights.compress_type == zipfile.ZIP_STORED
    want = sum(p.numel() * p.element_size() for p in
               [*port._params.parameters(), *port._params.buffers()])
    assert weights.file_size == stored["weight_bytes"] == want
    # no program carries a weight: none has state, and its constants
    # are the rasterizer's and preprocess's small tables (the padded
    # and text programs are loaded; the packed and embed ones are
    # traced the same way)
    for name in ("step.pt2", "text.pt2"):
        ep = torch.export.load(io.BytesIO(programs[name]))
        assert not ep.state_dict, name
        const = sum(t.numel() * t.element_size()
                    for t in ep.constants.values()
                    if isinstance(t, torch.Tensor))
        assert const < 64 * 1024, (name, const)
        kept = {str(n.target) for n in ep.graph.nodes
                if str(n.target).startswith("eventclip.")}
        if name != "text.pt2":
            assert kept == {"eventclip.event_histogram.default",
                            "eventclip.qkv_attention.default"}, name
        else:
            assert kept == {"eventclip.qkv_attention.default"}
    assert all(len(b) < weights.file_size for b in programs.values())


def test_exported_matches_live_and_jax(bundles, frozen):
    """Same streams, same chunking (a padded tail chunk, a subsampled
    stream) through the live port Predictor, the port bundle and the JAX
    bundle of the same weights."""
    streams = _long_streams(7)
    live = bundles["port"].predict(streams, top_k=2)
    got = frozen.predict(streams, top_k=2)
    _same(got, live)
    np.testing.assert_array_equal(got["topk"], live["topk"])
    want = bundles["jax_loaded"].predict(streams, top_k=2)
    _same(got, want)
    np.testing.assert_array_equal(got["topk"], want["topk"])
    # embeddings: live, the bundle and the JAX bundle
    e = frozen.embed(streams[:3])
    np.testing.assert_allclose(e, bundles["port"].embed(streams[:3]),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(e, bundles["jax_loaded"].embed(streams[:3]),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(np.linalg.norm(e, axis=-1), 1.0, atol=1e-4)
    assert frozen.embed([]).shape == (0, e.shape[-1])


def test_packed_program_serves_small_requests(bundles, frozen,
                                              monkeypatch):
    """A short request is served by a packed bucket program, not by the
    padded one: break the padded program and a one-stream request still
    answers."""
    assert frozen._buckets == bundles["bundle"][1]["buckets"]

    def boom(*a, **k):
        raise AssertionError("padded program dispatched for a packable "
                             "request")

    monkeypatch.setattr(frozen, "_step", boom)
    out = frozen.predict(_streams(np.random.default_rng(3), n=1))
    assert out["probs"].shape == (1, len(NAMES))
    np.testing.assert_allclose(out["probs"].sum(axis=-1), 1.0, rtol=1e-4)


def test_exported_host_contract(frozen):
    with pytest.raises(ValueError, match=r"event_streams\[1\]"):
        frozen.predict([np.zeros((10, 4), np.float32),
                        np.zeros((0, 4), np.float32)])
    out = frozen.predict([])
    assert out["probs"].shape == (0, 3) and out["names"] == []
    with pytest.raises(ValueError, match="n_cls=3"):
        frozen.set_classes(["just", "two"])
    with pytest.raises(ValueError, match="non-empty"):
        frozen.set_classes([])


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    """(live, path, meta): a padded-only bundle exported without a vocab
    on the build host and without embed, listing both device types."""
    port = _small()
    path = str(tmp_path_factory.mktemp("small") / "small.eclip")
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("EVENTCLIP_BPE_PATH", raising=False)
        meta = export_predictor(port, path, platforms=["cpu", "cuda"])
    return port, path, meta


def test_bundle_without_vocab_or_embed_refuses_as_jax(small):
    """Without a vocab on the build host the bundle has no text program,
    and without embed=True no embed program: JAX's refusal texts."""
    _, path, meta = small
    assert "vocab" in meta["text"]["skip"] and meta["embed"] is False
    frozen = ExportedPredictor(path, device="cpu")
    with pytest.raises(ValueError, match="re-export"):
        frozen.set_classes(["a", "b", "c"])
    with pytest.raises(RuntimeError, match="live Predictor"):
        frozen.embed([np.zeros((10, 4), np.float32)])


def test_offline_set_classes_matches_live_and_jax(bundles, frozen,
                                                  monkeypatch):
    """The bundled text program and BPE table swap labels offline as the
    live Predictor and the JAX bundle do."""
    swapped = ["cat", "point_cloud", "image of everything"]
    streams = _streams(np.random.default_rng(21), n=3)
    live = bundles["port"]
    monkeypatch.setattr(frozen, "_params", frozen._params)
    monkeypatch.setattr(frozen, "class_names", frozen.class_names)
    frozen.set_classes(swapped)
    assert frozen.class_names == swapped
    got = frozen.predict(streams)
    ref = RefExported(bundles["jax"])
    ref.set_classes(swapped)
    want = ref.predict(streams)
    live.set_classes(swapped)
    try:
        mine = live.predict(streams)
    finally:
        live.set_classes(NAMES)
    _same(got, mine)
    _same(got, want)


def test_exported_tta_bundle(bundles, tmp_path, monkeypatch):
    monkeypatch.delenv("EVENTCLIP_BPE_PATH", raising=False)
    ref = RefPredictor(_RefTinyZS(), class_names=NAMES, smoke=True,
                       batch_size=4, tta=True, pack_views=False)
    port = _port(ref, tta=True, pack_views=False)
    path = str(tmp_path / "tta.eclip")
    assert export_predictor(port, path)["tta"] is True
    jax_path = str(tmp_path / "jax_tta.eclip")
    ref_export(ref, jax_path)
    streams = _streams(np.random.default_rng(8), n=2)
    got = ExportedPredictor(path, device="cpu").predict(streams)
    _same(got, port.predict(streams))
    _same(got, RefExported(jax_path).predict(streams))


def test_exported_int8_bundle(bundles, tmp_path, monkeypatch):
    """The int8 tower (QWeight buffers: codes, scales) freezes into the
    bundle's weights and reproduces the live int8 predictions;
    vs the JAX int8 bundle at the int8 tolerances."""
    monkeypatch.delenv("EVENTCLIP_BPE_PATH", raising=False)
    kw = dict(int8=True, embed=True, pack_views=False)
    ref = RefPredictor(_RefTinyZS(), class_names=NAMES, smoke=True,
                       batch_size=4, **kw)
    # the JAX smoke towers come from a fixed key: the float ones of the
    # module's predictor are the ones ref quantized
    port = _port(ref, towers=bundles["ref"], **kw)
    path = str(tmp_path / "int8.eclip")
    meta = export_predictor(port, path)
    assert "int8" in {m["dtype"] for m in meta["params_manifest"]}
    jax_path = str(tmp_path / "jax_int8.eclip")
    ref_export(ref, jax_path)
    frozen = ExportedPredictor(path, device="cpu")
    streams = _streams(np.random.default_rng(9), n=3)
    got = frozen.predict(streams)
    _same(got, port.predict(streams))
    _same(got, RefExported(jax_path).predict(streams), atol=1e-4)
    e = frozen.embed(streams)
    np.testing.assert_allclose(e, port.embed(streams), atol=1e-5, rtol=0)
    assert np.linalg.norm(e - RefExported(jax_path).embed(streams),
                          axis=-1).max() <= 1e-3


def _rewrite_meta(src, dst, edit):
    with zipfile.ZipFile(src) as a, zipfile.ZipFile(dst, "w") as b:
        for name in a.namelist():
            data = a.read(name)
            if name == "meta.json":
                meta = json.loads(data.decode("utf-8"))
                edit(meta)
                data = json.dumps(meta)
            b.writestr(name, data)


def test_format_and_byteorder_gates(bundles, tmp_path):
    src = bundles["bundle"][0]
    path = str(tmp_path / "future.eclip")
    _rewrite_meta(src, path, lambda m: m.update(
        format_version="eventclip_tpu_torch/999"))
    with pytest.raises(ValueError, match="format eventclip_tpu_torch/999"):
        ExportedPredictor(path, device="cpu")
    path = str(tmp_path / "wrong_endian.eclip")
    _rewrite_meta(src, path, lambda m: m.update(
        byteorder="big" if m["byteorder"] == "little" else "little"))
    with pytest.raises(ValueError, match="endian"):
        ExportedPredictor(path, device="cpu")


def test_platform_gate_and_multi_platform_bundle(small, tmp_path):
    """A bundle lists the device types it loads on: a load elsewhere is
    refused with JAX's message. A bundle traced on the CPU may list both
    types (a load on the card moves the graph there: tests/test_torch_card.py);
    one traced on the card lists the card only."""
    port, both, meta = small
    assert meta["platforms"] == ["cpu", "cuda"]
    streams = _streams(np.random.default_rng(4), n=2)
    _same(ExportedPredictor(both, device="cpu").predict(streams),
          port.predict(streams))
    path = str(tmp_path / "cuda_only.eclip")
    _rewrite_meta(both, path, lambda m: m.update(platforms=["cuda"]))
    with pytest.raises(ValueError, match="was lowered for"):
        ExportedPredictor(path, device="cpu")
    with pytest.raises(ValueError, match="platforms"):
        export_predictor(port, path, platforms=["tpu"])
    # the device rule is checked before anything is traced
    on_card = SimpleNamespace(device=torch.device("cuda"))
    with pytest.raises(ValueError, match="loads on the card only"):
        export_predictor(on_card, path, platforms=["cuda", "cpu"])


def test_each_loader_refuses_the_other_bundle(bundles):
    with pytest.raises(ValueError, match=r"eventclip_tpu \(JAX\) bundle"):
        ExportedPredictor(bundles["jax"], device="cpu")
    with pytest.raises(ValueError, match="bundle format eventclip_tpu_torch"):
        RefExported(bundles["bundle"][0])


def test_offline_cli_from_export(bundles, tmp_path):
    """serve.main --from_export classifies dumps with the bundle; model
    flags baked at export time are refused."""
    rng = np.random.default_rng(11)
    for i, s in enumerate(_streams(rng, 3)):
        np.save(tmp_path / f"dump_{i}.npy", s.astype(np.float32))
    out_path = tmp_path / "preds.jsonl"
    serve.main(["--from_export", bundles["bundle"][0], "--inputs",
                str(tmp_path / "*.npy"), "--out", str(out_path), "--top_k",
                "2", "--cpu"])
    recs = [json.loads(ln) for ln in out_path.read_text().splitlines()]
    direct = bundles["port"].predict(
        [np.load(tmp_path / f"dump_{i}.npy") for i in range(3)], top_k=2)
    assert [r["name"] for r in recs] == direct["names"]
    assert [r["topk"] for r in recs] == direct["topk"].tolist()
    for bad in (["--int8"], ["--batch_size", "8"], ["--embed_out", "x"]):
        with pytest.raises(SystemExit):
            serve.main(["--from_export", bundles["bundle"][0], "--inputs",
                        str(tmp_path / "*.npy"), "--cpu"] + bad)
    with pytest.raises(SystemExit):  # exactly one source
        serve.main(["--inputs", str(tmp_path / "*.npy"), "--cpu"])


def test_export_cli_check(tmp_path, capsys, monkeypatch):
    """`python -m eventclip_tpu_torch.export --check` reloads the bundle
    and holds it to the live predictor (probabilities and the offline
    swap) within 1e-4 (padded programs only, for time)."""
    from eventclip_tpu_torch.export import main

    monkeypatch.setenv("EVENTCLIP_NO_PACK_EVAL", "1")

    names = tmp_path / "names.txt"
    names.write_text("\n".join(NAMES) + "\n")
    cfg = tmp_path / "cfg.py"
    cfg.write_text(
        "from eventclip_tpu_torch.utils.config import Params\n\n\n"
        "class EventCLIPParams(Params):\n"
        "    dataset = 'n_caltech'\n"
        "    data_root = '/nonexistent'\n"
        "    quantize_args = dict(max_imgs=2, N=1000,"
        " split_method='event_count', convert_method='event_histogram',"
        " grayscale=True, count_non_zero=False, background_mask=True)\n"
        "    model = 'ZSCLIP'\n"
        "    clip_dict = dict(arch='ViT-T/8@32',"
        " prompt='a point cloud image of a {}', agg_func='mean')\n"
        "    bf16 = False\n")
    main(["--params", str(cfg), "--classes", str(names), "--smoke",
          "--cpu", "--batch_size", "4", "--out", str(tmp_path / "cli.eclip"),
          "--check"])
    out = capsys.readouterr().out
    assert "check OK" in out and "set_classes prob delta" in out


def test_server_from_exported_bundle(bundles, frozen):
    """An HTTP server handed an ExportedPredictor answers /healthz,
    /classes and /predict like the live predictor, and a label-count
    change is a clean 400."""
    from eventclip_tpu_torch.client import ServingClient, ServingError
    from eventclip_tpu_torch.server import make_server

    from .test_torch_server import _start

    srv = make_server(frozen, "127.0.0.1", 0)
    try:
        c = ServingClient(_start(srv))
        h = c.health()
        assert (h["model"], h["arch"], h["n_classes"]) == (
            "ZSCLIP", "ViT-T/8@32", 3)
        assert c.classes() == NAMES
        streams = _streams(np.random.default_rng(3), 5)
        got = c.predict(streams, top_k=2, return_probs=True)
        _same(got, bundles["port"].predict(streams, top_k=2))
        with pytest.raises(ServingError, match="same count") as e:
            c.set_classes(["just", "two"])
        assert e.value.status == 400
    finally:
        srv.shutdown()
