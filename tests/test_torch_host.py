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
    for name, stats in DATASET_CLASSES.items():
        ref = REF_DATASETS[name]
        for field in dataclasses.fields(stats):
            assert getattr(stats, field.name) == getattr(ref, field.name), (
                name, field.name)
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
    """A fresh interpreter that builds and runs a tiny CPU Predictor has
    neither jax nor any eventclip_tpu module loaded."""
    code = textwrap.dedent("""
        import sys
        import numpy as np
        from eventclip_tpu_torch.serve import Predictor
        from eventclip_tpu_torch.utils.config import load_params
        p = load_params("configs/debug/zsclip_tiny_params.py")
        pred = Predictor(p, ["a", "b"], smoke=True, batch_size=2,
                         device="cpu")
        rng = np.random.default_rng(0)
        ev = np.stack([rng.integers(0, 240, 1500), rng.integers(0, 180, 1500),
                       np.sort(rng.uniform(0, 0.3, 1500)),
                       rng.choice([-1.0, 1.0], 1500)], 1)
        assert pred.predict([ev])["probs"].shape == (1, 2)
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
    one FS update on event windows with RandAugment, and builds a model
    with models.factory, has neither jax nor any eventclip_tpu module
    loaded."""
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
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith("jax.")
                     or m == "eventclip_tpu" or m.startswith("eventclip_tpu."))
        print("LOADED", bad)
        sys.exit(1 if bad else 0)
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=180)
    assert res.returncode == 0, res.stdout + res.stderr
