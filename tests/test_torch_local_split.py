"""Data parallelism over local cards (parallel/local.py) against one part
and the JAX package's data-parallel predictor.

`Predictor(data_parallel=True, devices=["cpu", "cpu"])` replicates the
model twice and splits every batch in two; the JAX `Predictor(
data_parallel=True)` shards it over the 8 host devices of
tests/conftest.py. Random ViT-T/8@32 towers give nearly one-hot ZS
probabilities, so the per-stream features (`embed`) carry the
comparison, as in tests/test_torch_serve_options.py: f32, rtol 1e-5,
atol 1e-6 against JAX, and against one part within 1e-6 (the parts'
products see other row counts, whose sums may round apart). The eval CLI
and the teacher of gen_data over two CPU parts must print what one part
prints.
"""

import os
import signal
import threading
import time

import numpy as np
import pytest
import torch

from eventclip_tpu import serve as ref_serve
from eventclip_tpu_torch import serve, server
from eventclip_tpu_torch.client import ServingClient
from eventclip_tpu_torch.export import export_predictor
from eventclip_tpu_torch.parallel import local

from .test_torch_cli import files as cli_files  # noqa: F401
from .test_torch_gen_data import files as gen_files  # noqa: F401
from .test_torch_serve_options import (NAMES, ZS, _params,  # noqa: F401
                                       _port, _same, _streams, towers)

CPU2 = ["cpu", "cpu"]


@pytest.fixture(scope="module")
def streams():
    # 1 .. > 10 views each: packed and padded chunks, a ragged tail
    return _streams(3, lengths=(600, 2800, 4100, 13700, 900, 1500, 7000))


@pytest.fixture(scope="module")
def ref_dp(towers):  # noqa: F811
    return ref_serve.Predictor(_params(ZS, False), NAMES, smoke=True,
                               batch_size=4, data_parallel=True, embed=True)


@pytest.mark.parametrize("pack_views", [True, False])
def test_split_predictor_equals_one_part_and_jax(towers, ref_dp,  # noqa
                                                 streams, pack_views):
    one = _port(towers, embed=True, pack_views=pack_views)
    two = _port(towers, embed=True, pack_views=pack_views,
                data_parallel=True, devices=CPU2)
    assert two._split.n == 2 and two.batch_size == 4
    assert two._buckets == (one._buckets and two._buckets)
    _same(two.predict(streams), one.predict(streams), atol=1e-6)
    got = two.embed(streams)
    np.testing.assert_allclose(got, one.embed(streams), rtol=0, atol=1e-6)
    # the JAX predictor on its 8-device mesh (batch 4 rounds to 8 there)
    want = ref_dp.embed(streams)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_split_counts_one_histogram_a_part(towers, streams, monkeypatch):
    """K1 runs once for each part of a chunk, on that part's rows."""
    seen = []
    raster = local.rasterize_for_clip

    def spy(spec, pp, w):
        seen.append(int(w.shape[0]))
        return raster(spec, pp, w)

    monkeypatch.setattr(local, "rasterize_for_clip", spy)
    two = _port(towers, data_parallel=True, devices=CPU2)
    wins, valids = two.gather_windows(streams[:4])
    batch = two._place_chunk(wins, valids)
    two._forward(batch)
    assert len(seen) == 2 and seen[0] == seen[1]
    assert sum(seen) == batch["windows"].shape[0]


@pytest.mark.parametrize("asked,got", [(5, 4), (1, 2), (6, 6)])
def test_split_batch_size_rounds_down(towers, asked, got):  # noqa: F811
    tree, tf, _ = towers
    pred = serve.Predictor(_params(ZS, True), NAMES, clip_params=tree,
                           text_feats=tf, batch_size=asked, device="cpu",
                           data_parallel=True, devices=CPU2)
    assert pred.batch_size == got
    assert all(k % 8 == 0 for k in pred._buckets)


def test_split_int8_tta_and_set_classes(towers, streams):  # noqa: F811
    one = _port(towers, int8=True, tta=True, embed=True)
    two = _port(towers, int8=True, tta=True, embed=True,
                data_parallel=True, devices=CPU2)
    np.testing.assert_allclose(two.embed(streams), one.embed(streams),
                               rtol=0, atol=1e-6)
    names = ["cat", "dog", "tree"]
    os.environ.pop("EVENTCLIP_BPE_PATH", None)
    one.set_classes(names)
    two.set_classes(names)
    assert two.class_names == names
    for r in two._split.replicas:
        torch.testing.assert_close(r.text_feats, one._params.text_feats,
                                   rtol=0, atol=0)
    _same(two.predict(streams), one.predict(streams), atol=1e-6)


def test_split_stream_session(towers, streams):  # noqa: F811
    two = _port(towers, data_parallel=True, devices=CPU2)
    one = _port(towers)
    sess = serve.StreamSession(two)
    sess.append(streams[3][:5000])
    sess.append(streams[3][5000:])
    got = sess.predict(top_k=2)
    want = one.predict([sess.events()], top_k=2)
    np.testing.assert_allclose(got["probs"], want["probs"][0], atol=1e-6,
                               rtol=0)
    assert got["label"] == int(want["label"][0])


def test_export_refuses_a_split_predictor(towers, tmp_path):  # noqa: F811
    two = _port(towers, data_parallel=True, devices=CPU2)
    with pytest.raises(ValueError, match="data_parallel=False"):
        export_predictor(two, str(tmp_path / "b.eclip"))


def test_server_data_parallel_answers(towers, streams, monkeypatch,  # noqa
                                     tmp_path):
    """`server --data_parallel` builds a split predictor and answers
    /predict as one part does (in-process: the Predictor it builds gets
    the test's towers and two CPU parts)."""
    names = tmp_path / "names.txt"
    names.write_text("\n".join(NAMES) + "\n")
    tree, tf, _ = towers
    built, made = {}, {}
    real_make = server.make_server

    def predictor(*a, **k):
        assert k["data_parallel"] is True
        k.update(clip_params=tree, text_feats=tf, devices=CPU2)
        built["pred"] = serve.Predictor(*a, **k)
        return built["pred"]

    def make(*a, **k):
        made["server"] = real_make(*a, **k)
        return made["server"]

    monkeypatch.setattr(server, "Predictor", predictor)
    monkeypatch.setattr(server, "make_server", make)
    monkeypatch.setattr(signal, "signal", lambda *a: None)
    th = threading.Thread(target=server.main, args=([
        "--params", ZS, "--classes", str(names), "--smoke", "--cpu",
        "--port", "0", "--batch_size", "4", "--data_parallel"],),
        daemon=True)
    th.start()
    deadline = time.monotonic() + 120
    while "server" not in made and time.monotonic() < deadline:
        time.sleep(0.05)
    srv = made["server"]
    try:
        url = f"http://127.0.0.1:{srv.server_address[1]}"
        got = ServingClient(url).predict(streams[:3], return_probs=True)
        assert built["pred"]._split.n == 2
        want = _port(towers).predict(streams[:3])
        np.testing.assert_array_equal(got["label"], want["label"])
        np.testing.assert_allclose(got["probs"], want["probs"], atol=1e-6,
                                   rtol=0)
    finally:
        srv.shutdown()
        th.join(60)
    assert not th.is_alive()


# -- the eval CLI and the teacher of gen_data over two CPU parts -----------------


@pytest.mark.parametrize("extra", [[], ["--int8"]])
def test_cli_test_two_local_parts_equal_one(cli_files, capsys, monkeypatch,
                                            extra):
    from eventclip_tpu_torch.cli import test as cli_test

    from .test_torch_cli import ZS as CLI_ZS
    from .test_torch_cli import _eval_lines

    tree, pt, _ = cli_files
    argv = ["--params", CLI_ZS, "--clip_ckpt", pt, "--data_root", tree,
            "--fp32", "--cpu"] + extra
    one = cli_test.main(argv)
    want = _eval_lines(capsys.readouterr().out)
    monkeypatch.setattr(cli_test, "local_devices",
                        lambda d: [torch.device("cpu")] * 2)
    two = cli_test.main(argv)
    assert two["ctx"]["split"].n == 2
    assert _eval_lines(capsys.readouterr().out) == want
    assert (two["probs_acc"], two["logits_acc"]) == \
        (one["probs_acc"], one["logits_acc"])
    assert two["ctx"]["evals"][0]["n"] == one["ctx"]["evals"][0]["n"]


@pytest.mark.parametrize("flags", [["--tta", "--tta_consistent"], []])
def test_gen_data_two_local_parts_label_like_one(gen_files, tmp_path,
                                                 monkeypatch, flags):
    import contextlib
    import io

    from eventclip_tpu_torch.cli import gen_data

    from .test_torch_gen_data import report, tree_links

    argv = ["--params", gen_files["zs"], "--clip_ckpt", gen_files["pt"],
            "--data_root", gen_files["nc"], "--fp32", "--cpu",
            "--conf_thresh", "0.0"] + flags
    outs = []
    for parts, name in ((1, "one"), (2, "two")):
        monkeypatch.setattr(gen_data, "local_devices",
                            lambda d, k=parts: [torch.device("cpu")] * k)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            gen_data.main(argv + ["--save_path", str(tmp_path / name)])
        outs.append(report(buf.getvalue()))
    assert outs[0] == outs[1] and "Select " in outs[0]
    assert tree_links(str(tmp_path / "two")) == \
        tree_links(str(tmp_path / "one"))
