"""The port's host half equals the JAX package's: windows, host ops, config
loading, the arch and sensor tables and view packing (all exact), and the
port's serving path imports neither JAX nor the JAX package."""

import dataclasses
import glob
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from eventclip_tpu.data import host_ops as ref_host
from eventclip_tpu.data import loader as ref_loader
from eventclip_tpu.data.datasets import DATASET_CLASSES as REF_DATASETS
from eventclip_tpu.data.event_windows import (
    parse_quantize_args as ref_parse_quantize_args,
)
from eventclip_tpu.models.clip.config import CLIP_ARCHS as REF_ARCHS
from eventclip_tpu.ops import windows as ref_windows
from eventclip_tpu.utils.config import load_params as ref_load_params
from eventclip_tpu_torch.data import host_ops, loader
from eventclip_tpu_torch.data.datasets import DATASET_CLASSES
from eventclip_tpu_torch.data.event_windows import parse_quantize_args
from eventclip_tpu_torch.models.clip.config import CLIP_ARCHS
from eventclip_tpu_torch.ops import windows
from eventclip_tpu_torch.utils.config import load_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(ROOT, "configs", "**", "*.py"),
                           recursive=True))


def make_stream(rng, n, H=180, W=240):
    return np.stack([
        rng.integers(0, W, n),
        rng.integers(0, H, n),
        np.sort(rng.uniform(0.05, 0.3, n)),
        rng.choice([-1.0, 1.0], n),
    ], axis=1).astype(np.float32)


def test_windows_equal_reference():
    for n in range(1, 700, 7):
        for N in (32, 100, 128, 150):
            assert windows.num_windows(n, N) == ref_windows.num_windows(n, N)
            assert (windows.event_count_windows(n, N)
                    == ref_windows.event_count_windows(n, N)), (n, N)


def test_center_shift_flip_equal_reference(rng):
    ev = make_stream(rng, 700)
    ev[:, 0] = ev[:, 0] % 70  # off-centre so centering has work to do
    res = (180, 240)
    np.testing.assert_array_equal(host_ops.center_events(ev.copy(), res),
                                  ref_host.center_events(ev.copy(), res))
    np.testing.assert_array_equal(
        host_ops.shift_events_by(ev.copy(), 30, -12, res),
        ref_host.shift_events_by(ev.copy(), 30, -12, res))
    np.testing.assert_array_equal(
        host_ops.hflip_events(ev.copy(), res, p=1.0),
        ref_host.hflip_events(ev.copy(), res, p=1.0))
    np.testing.assert_array_equal(host_ops.tflip_events(ev.copy(), p=1.0),
                                  ref_host.tflip_events(ev.copy(), p=1.0))


@pytest.mark.parametrize("augment,flip_time", [(False, False), (True, False),
                                               (True, True)])
def test_prepare_stream_equals_reference(augment, flip_time):
    ev = make_stream(np.random.default_rng(3), 900, H=100, W=120)
    for seed in range(4):
        got = host_ops.prepare_stream(
            ev, (100, 120), rng=np.random.default_rng(seed), augment=augment,
            flip_time=flip_time, max_shift=10)
        want = ref_host.prepare_stream(
            ev, (100, 120), rng=np.random.default_rng(seed), augment=augment,
            flip_time=flip_time, max_shift=10)
        np.testing.assert_array_equal(got, want)


def test_tta_variants_equal_reference(rng):
    ev = ref_host.center_events(make_stream(rng, 500), (180, 240))
    got = host_ops.tta_variants(ev.copy(), (180, 240))
    want = ref_host.tta_variants(ev.copy(), (180, 240))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("n", [300, 1000, 1499, 1501, 12345])
def test_gather_event_windows_equal_reference(packed, n):
    """Short streams, the tail-window rule at both sides of N/2, and
    subsampling of long streams (more windows than view slots)."""
    ev = ref_host.center_events(make_stream(np.random.default_rng(n), n),
                                (180, 240))
    got = host_ops.gather_event_windows(ev, 1000, 10,
                                        rng=np.random.default_rng(1),
                                        packed=packed)
    want = ref_host.gather_event_windows(ev, 1000, 10,
                                         rng=np.random.default_rng(1),
                                         packed=packed)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_max_views_and_quantize_args_equal_reference():
    for max_n in (12500, 135000, 225000):
        for window in (1000, 20000, 30000, 70000):
            for limit in (1, 2, 10):
                assert (host_ops.max_views(max_n, window, limit)
                        == ref_host.max_views(max_n, window, limit))
    for path in CONFIGS:
        p = load_params(path)
        ds = DATASET_CLASSES[p.dataset]
        for hard_limit in (None, 10):
            assert (parse_quantize_args(p.quantize_args, ds.resolution,
                                        ds.max_n, hard_limit)
                    == ref_parse_quantize_args(p.quantize_args,
                                               ds.resolution, ds.max_n,
                                               hard_limit)), path


@pytest.mark.parametrize("path", CONFIGS,
                         ids=[os.path.relpath(p, ROOT) for p in CONFIGS])
def test_every_config_loads_identically(path):
    got = load_params(path)
    want = ref_load_params(path)
    assert got.to_dict() == want.to_dict()
    assert got.get("model") == want.get("model")


def test_config_loader_takes_dotted_module_paths(monkeypatch):
    monkeypatch.chdir(ROOT)
    got = load_params("configs.zsclip.zsclip_ncaltech_params")
    assert got.to_dict() == load_params(
        os.path.join(ROOT, "configs/zsclip/zsclip_ncaltech_params.py")
    ).to_dict()


def test_sensor_and_arch_tables_equal_reference():
    assert set(DATASET_CLASSES) == set(REF_DATASETS)
    for name, reader in DATASET_CLASSES.items():
        ref = REF_DATASETS[name]
        assert reader.__name__ == ref.__name__
        for attr in ("resolution", "max_t", "max_n", "max_shift",
                     "flip_time", "new_cnames"):
            assert getattr(reader, attr) == getattr(ref, attr), (name, attr)
    assert set(CLIP_ARCHS) == set(REF_ARCHS)
    for name, cfg in CLIP_ARCHS.items():
        assert dataclasses.asdict(cfg) == dataclasses.asdict(REF_ARCHS[name])
        assert cfg.embed_dim == REF_ARCHS[name].embed_dim


@pytest.mark.parametrize("n_valid", [0, 1, 7, 13, 40])
def test_view_packing_equals_reference(n_valid):
    rng = np.random.default_rng(n_valid)
    B, T = 4, 10
    assert loader.view_pack_buckets(B * T) == ref_loader.view_pack_buckets(
        B * T)
    buckets = loader.eval_pack_buckets(B, T, 1)
    assert buckets == ref_loader.eval_pack_buckets(B, T, 1)
    valid = np.zeros(B * T, bool)
    valid[rng.permutation(B * T)[:n_valid]] = True
    batch = {"windows": rng.integers(-5, 5, (B, T, 6, 3)).astype(np.int16),
             "valid_mask": valid.reshape(B, T)}
    got = loader.pack_view_batch(dict(batch), buckets)
    want = ref_loader.pack_view_batch(dict(batch), buckets)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_serving_path_imports_no_jax():
    """A fresh interpreter that builds and runs a tiny CPU Predictor, then
    one with the int8 tower (ops.quant), token pruning and embeddings, its
    host half through the native library (eventclip_tpu_torch.native),
    serves it over HTTP (server, client) and freezes a bundle of it
    (export, the custom ops of ops.custom_ops) that it loads and serves,
    also as a bundle of two graph sets, has neither jax nor any
    eventclip_tpu module loaded."""
    code = textwrap.dedent("""
        import sys
        import numpy as np
        from eventclip_tpu_torch import native
        from eventclip_tpu_torch.serve import Predictor, StreamSession
        from eventclip_tpu_torch.utils.config import load_params
        p = load_params("configs/debug/zsclip_tiny_params.py")
        pred = Predictor(p, ["a", "b"], smoke=True, batch_size=2,
                         device="cpu")
        rng = np.random.default_rng(0)
        ev = np.stack([rng.integers(0, 240, 1500), rng.integers(0, 180, 1500),
                       np.sort(rng.uniform(0, 0.3, 1500)),
                       rng.choice([-1.0, 1.0], 1500)], 1)
        assert pred.predict([ev])["probs"].shape == (1, 2)
        fast = Predictor(p, ["a", "b"], smoke=True, batch_size=2,
                         device="cpu", int8=True, int8_calib_streams=[ev],
                         prune_tokens=8, embed=True)
        native.reset_calls()
        assert fast.embed([ev]).shape == (1, 32)
        sess = StreamSession(fast)
        sess.append(ev)
        assert sess.predict()["probs"].shape == (2,)
        assert native.available() and native.CALLS["transform"] == 2
        import tempfile, threading
        from eventclip_tpu_torch.client import ServingClient
        from eventclip_tpu_torch.export import (ExportedPredictor,
                                                export_predictor)
        from eventclip_tpu_torch.server import make_server
        srv = make_server(pred, "127.0.0.1", 0)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        c = ServingClient(f"http://127.0.0.1:{srv.server_address[1]}")
        assert c.predict([ev])["names"] == pred.predict([ev])["names"]
        srv.shutdown()
        one = Predictor(p, ["a", "b"], smoke=True, batch_size=2,
                        device="cpu", pack_views=False)
        with tempfile.TemporaryDirectory() as d:
            export_predictor(one, d + "/b.eclip")
            frozen = ExportedPredictor(d + "/b.eclip", device="cpu")
            assert (frozen.predict([ev])["probs"]
                    == one.predict([ev])["probs"]).all()
            # a bundle of two graph sets (the CPU's copied as the card's)
            import json, zipfile
            with zipfile.ZipFile(d + "/b.eclip") as a, \
                    zipfile.ZipFile(d + "/two.eclip", "w") as b:
                for n in a.namelist():
                    data = a.read(n)
                    if n == "meta.json":
                        m = json.loads(data)
                        m["platforms"] = ["cpu", "cuda"]
                        m["sets"]["cuda"] = {"set": "cuda",
                                             "traced_on": "cuda"}
                        data = json.dumps(m)
                    elif n.startswith("cpu/"):
                        b.writestr("cuda/" + n[4:], data)
                    b.writestr(n, data)
            two = ExportedPredictor(d + "/two.eclip", device="cpu")
            assert (two.predict([ev])["probs"]
                    == one.predict([ev])["probs"]).all()
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith("jax.")
                     or m == "eventclip_tpu" or m.startswith("eventclip_tpu."))
        print("LOADED", bad)
        sys.exit(1 if bad else 0)
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_training_path_imports_no_jax():
    """A fresh interpreter that imports every module of the port and
    chip_smoke.py, then takes one FT update of a tiny tower with remat and
    one FS update on event windows with RandAugment, builds a model with
    models.factory, tokenizes prompts, reads a split asset, converts
    towers (ViT and ResNet) through the OpenAI key layout, runs a ResNet
    tower and the pseudo-labelling filter, the data-parallel helpers, a
    sharded loader, adaptive prefetch and the viz helpers, the sharding
    rules, one tensor-parallel rank's forward, ZeRO-1's optimizer and the
    local split, converts a `.pt` and a trainable checkpoint both ways
    (cli.convert_clip, cli.convert_checkpoint) and runs the parity
    harness's tower stage (cli.parity_check), has neither jax, nor regex,
    nor any eventclip_tpu module loaded."""
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        import torch
        import eventclip_tpu_torch
        for m in pkgutil.walk_packages(eventclip_tpu_torch.__path__,
                                       "eventclip_tpu_torch."):
            importlib.import_module(m.name)
        import chip_smoke
        from eventclip_tpu_torch.engine.optim import (OptimConfig,
                                                      Optimizer)
        from eventclip_tpu_torch.engine.train import make_train_step
        from eventclip_tpu_torch.models import classifier
        from eventclip_tpu_torch.models.clip.config import clip_arch_config
        from eventclip_tpu_torch.utils.config import load_params
        cfg = classifier.ClassifierConfig(
            model="FTCLIP", clip=clip_arch_config("ViT-T/8@32"), remat=True,
            prompt_tuning=True)
        p = classifier.init_classifier_params(
            cfg, torch.Generator().manual_seed(0), n_classes=3)
        step = make_train_step(cfg, p, Optimizer(cfg, OptimConfig(), p))
        m = step({"img": torch.randn(2, 2, 3, 32, 32),
                  "valid_mask": torch.ones(2, 2, dtype=torch.bool),
                  "label": torch.tensor([0, 2])})
        assert torch.isfinite(m["total_loss"])
        # the FS slice's modules by name: adapter, RandAugment, factory
        from eventclip_tpu_torch.models import adapter, factory
        from eventclip_tpu_torch.ops import randaugment
        from eventclip_tpu_torch.ops.preprocess import ClipPreprocess
        from eventclip_tpu_torch.ops.rasterize import RasterSpec
        clip = clip_arch_config("ViT-T/8@32")
        fs = classifier.ClassifierConfig(
            model="FSCLIP", clip=clip, prompt_tuning=True,
            adapter=adapter.AdapterConfig(
                adapter_type="trans", in_dim=clip.embed_dim, d_model=16,
                num_heads=2, ffn_dim=64))
        q = classifier.init_classifier_params(
            fs, torch.Generator().manual_seed(0), n_classes=3)
        step = make_train_step(
            fs, q, Optimizer(fs, OptimConfig(), q), augment=True,
            pipeline=(RasterSpec(height=24, width=32, window=64),
                      ClipPreprocess(24, 32, 32)))
        g = torch.Generator().manual_seed(1)
        wins = torch.stack([torch.randint(0, 32, (2, 2, 64), generator=g),
                            torch.randint(0, 24, (2, 2, 64), generator=g),
                            torch.ones(2, 2, 64, dtype=torch.int64)], -1)
        m = step({"windows": wins.to(torch.int16),
                  "valid_mask": torch.ones(2, 2, dtype=torch.bool),
                  "label": torch.tensor([0, 2])})
        assert torch.isfinite(m["total_loss"])
        model = factory.build_model(
            load_params("configs/debug/fsclip_tiny_params.py"), ["a", "b"],
            dtype=torch.float32, device="cpu")
        assert randaugment.OP_NAMES[0] == "Identity"
        # the data-to-accuracy slice: tokenizer, readers, converters, CLIs
        from eventclip_tpu_torch.cli import test as cli_test
        from eventclip_tpu_torch.data import datasets
        from eventclip_tpu_torch.models.clip import convert, tokenizer
        tok = tokenizer.SimpleTokenizer(merges=[("a", "t</w>"),
                                                ("c", "at</w>")])
        ids = tokenizer.tokenize(["a cat", "\u0430 \u088f 4\u0663!"], tok)
        assert ids.shape == (2, 77) and ids[0, 2] == tok.encoder["cat</w>"]
        assert len(datasets.load_split_asset("NCaltech101", 2, True)) == 202
        assert datasets.build_dataset and cli_test.find_weight
        sd = chip_smoke.openai_state_dict(model.params.clip)
        assert convert.infer_config_from_state_dict(sd).vision.layers == 2
        # the ninth slice: a ResNet tower through its `.pt` layout, and
        # the pseudo-labelling CLI's filter
        import numpy as np
        from eventclip_tpu_torch.cli import gen_data
        from eventclip_tpu_torch.models.clip.model import init_clip_params
        from eventclip_tpu_torch.models.clip.resnet import (
            encode_image_resnet)
        rn = init_clip_params(clip_arch_config("RN-T@32"),
                              torch.Generator().manual_seed(0))
        rn = convert.clip_from_jax(convert.convert_clip_state_dict(
            chip_smoke.openai_state_dict(rn)), rn.cfg, device="cpu")
        x = encode_image_resnet(rn.visual, torch.randn(2, 3, 32, 32))
        assert x.shape == (2, 32)
        sel = gen_data.Selection(["a", "b"])
        gen_data.filter_batch(
            sel, np.array([[.9, .1]], np.float32), np.array([0]),
            np.array([True]), ["r/a/0.npy"], set(), tta=False,
            tta_consistent=False, tta_min_prob=False, conf_thresh=.5,
            topk=-1)
        assert sel.path2cls == {"r/a/0.npy": "a"}
        # the eleventh slice: the data-parallel helpers, the sharded
        # loader, adaptive prefetch and the validation GIFs' helpers
        from eventclip_tpu_torch.data import loader
        from eventclip_tpu_torch.parallel import distributed
        from eventclip_tpu_torch.utils import viz
        assert distributed.host_shard_info() == (0, 1)
        assert distributed.gather_objects({"a": 1}) == [{"a": 1}]
        assert not distributed.any_process_flag(False)
        shard = list(loader.PrefetchLoader(
            [{"x": np.zeros(2), "label": i} for i in range(2)], 4,
            num_workers=1, shard_index=1, num_shards=2, pad_last=True))
        assert shard[0]["sample_mask"].tolist() == [False, False]
        assert list(loader.adaptive_prefetch(range(3), lambda b: b)) == [
            0, 1, 2]
        assert viz.denormalize(np.zeros((3, 2, 2))).shape == (2, 2, 3)
        # the twelfth slice: the sharding rules and the tensor-parallel
        # forward (one rank of a 2-way model axis, no group: its sums are
        # no-ops), ZeRO-1's optimizer and the local split
        from eventclip_tpu_torch.models.clip.model import encode_image
        from eventclip_tpu_torch.parallel import local, sharding
        tp = sharding.TPContext(n_data=1, n_model=2, data_index=0,
                                model_index=1)
        sharding.shard_params(p, tp)
        assert p.clip.visual.blocks.layers[0].attn.wqkv.shape == (96, 64)
        assert encode_image(p.clip.visual, torch.randn(2, 3, 32, 32),
                            tp=tp).shape == (2, 32)
        assert sharding.zero1_pspecs({"a/w": (8, 6)}, 2) == {
            "a/w": ("data", None)}
        assert Optimizer(cfg, OptimConfig(), p, zero1=True).zero1 is False
        assert local.LocalSplit(q, ["cpu", "cpu"]).n == 2
        # the thirteenth slice: the converters and the parity harness
        import tempfile
        from eventclip_tpu_torch.cli import (convert_checkpoint,
                                             convert_clip, parity_check)
        from eventclip_tpu_torch.engine.checkpoint import save_trainable
        from tests.torch_oracle import random_clip_state_dict
        with tempfile.TemporaryDirectory() as d:
            torch.save(random_clip_state_dict(np.random.default_rng(0)),
                       d + "/c.pt")
            convert_clip.main([d + "/c.pt", d + "/c.npz"])
            save_trainable(d + "/fs.npz", fs, q)
            convert_checkpoint.main([d + "/fs.npz", d + "/fs.pth"])
            convert_checkpoint.main([d + "/fs.pth", d + "/back.npz"])
            assert sorted(np.load(d + "/back.npz").files) == sorted(
                np.load(d + "/fs.npz").files)
            assert parity_check.main(["--clip_ckpt", d + "/c.pt", "--out",
                                      d + "/r.json", "--cpu"]) == 0
        bad = sorted(m for m in sys.modules
                     if m in ("jax", "regex") or m.startswith("jax.")
                     or m == "eventclip_tpu" or m.startswith("eventclip_tpu."))
        print("LOADED", bad)
        sys.exit(1 if bad else 0)
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=180)
    assert res.returncode == 0, res.stdout + res.stderr
