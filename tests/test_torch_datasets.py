"""The port's dataset readers equal the JAX package's.

On synthetic trees (tests/test_e2e.py's `.npy` N-Caltech tree and
structured-npz N-ImageNet tree, plus trees holding the files a shipped
split names) each reader's classes, files, labels and items (event-space
augmentation on, over two epochs) are equal, on the shipped-split and the
seeded-sampling branches; the npz decode, `build_dataset` for the four
datasets (TTA items too) and the split assets are equal as well.
"""

import gzip
import json
import os

import numpy as np
import pytest

from eventclip_tpu.data import datasets as ref_ds
from eventclip_tpu.data import event_windows as ref_ew
from eventclip_tpu.utils.config import load_params as ref_load_params
from eventclip_tpu_torch.data import datasets as ds
from eventclip_tpu_torch.data import event_windows as ew
from eventclip_tpu_torch.utils.config import load_params

from .test_e2e import make_nin_tree, make_tree

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NPZ_DTYPE = np.dtype([("x", "<u2"), ("y", "<u2"), ("t", "<i8"), ("p", "u1")])


def _npy_events(rng, n, H, W):
    return np.stack([rng.integers(0, W, n), rng.integers(0, H, n),
                     np.sort(rng.uniform(0, 0.3, n)),
                     rng.choice([-1.0, 1.0], n)], axis=1)


def _npz_events(path, rng, n=600):
    ev = np.zeros(n, dtype=NPZ_DTYPE)
    ev["x"] = rng.integers(0, 640, n)
    ev["y"] = rng.integers(0, 480, n)
    ev["t"] = np.sort(rng.integers(0, 50000, n))
    ev["p"] = rng.integers(0, 2, n)
    np.savez(path, event_data=ev)


def _split_tree(root, split_of, rel_root, write, rng):
    """Write every file a shipped split names under `root`/`rel_root`."""
    for rel in split_of:
        cls, fn = rel.split("/")[-2:]
        d = os.path.join(root, rel_root, cls)
        os.makedirs(d, exist_ok=True)
        write(os.path.join(d, fn), rng)


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    base = tmp_path_factory.mktemp("trees")
    rng = np.random.default_rng(11)
    caltech = make_tree(str(base / "caltech"))
    # N-Caltech training tree of exactly the 2-shot split's 202 files
    shipped = str(base / "caltech_split")
    _split_tree(shipped, ds.load_split_asset("NCaltech101", 2, True),
                "training", lambda p, r: np.save(
                    p, _npy_events(r, 400 + int(r.integers(0, 300)), 180,
                                   240)), rng)
    for c in ("ant", "brain", "Faces_easy"):
        d = os.path.join(shipped, "testing", c)
        os.makedirs(d)
        np.save(os.path.join(d, f"{c}_0.npy"), _npy_events(rng, 900, 180,
                                                            240))
    cars = str(base / "cars")
    for split, k in (("train", 5), ("test", 3)):
        for c in ("cars", "background"):
            d = os.path.join(cars, split, c)
            os.makedirs(d)
            for i in range(k):
                np.save(os.path.join(d, f"{c}_{i}.npy"),
                        _npy_events(rng, 800 + 50 * i, 100, 120))
    nin = make_nin_tree(str(base / "nin"))
    # N-ImageNet-Mini: the 1-shot split's 100 files, one val file a class
    mini = str(base / "mini")
    _split_tree(mini, ds.load_split_asset("NImageNetMini", 1, True),
                "extracted_train", lambda p, r: _npz_events(p, r), rng)
    for wnid in [k for k, v in ds.imagenet_folder2name().items()
                 if v in ds.MINI_NAMES]:
        d = os.path.join(mini, "extracted_val", wnid)
        os.makedirs(d, exist_ok=True)
        _npz_events(os.path.join(d, f"{wnid}_0.npz"), rng)
    return dict(caltech=caltech, shipped=shipped, cars=cars, nin=nin,
                mini=mini)


def test_assets_are_byte_equal_copies():
    ref = os.path.join(ROOT, "eventclip_tpu", "assets")
    mine = os.path.join(ROOT, "eventclip_tpu_torch", "assets")
    files = sorted(os.path.relpath(os.path.join(d, f), ref)
                   for d, _, fs in os.walk(ref) for f in fs)
    assert len(files) == 36
    assert files == sorted(os.path.relpath(os.path.join(d, f), mine)
                           for d, _, fs in os.walk(mine) for f in fs)
    for rel in files:
        with open(os.path.join(ref, rel), "rb") as a, \
                open(os.path.join(mine, rel), "rb") as b:
            assert a.read() == b.read(), rel


def test_tables_and_split_assets_equal():
    assert ds.CALTECH_NEW_CNAMES == ref_ds.CALTECH_NEW_CNAMES
    assert ds.CARS_NEW_CNAMES == ref_ds.CARS_NEW_CNAMES
    assert ds.MINI_NAMES == ref_ds.MINI_NAMES
    assert ds.NIN_VAL_SUBSETS == ref_ds.NIN_VAL_SUBSETS
    assert ds.imagenet_folder2name() == ref_ds.imagenet_folder2name()
    assert set(ds.DATASET_CLASSES) == set(ref_ds.DATASET_CLASSES)
    for name in os.listdir(os.path.join(ds.ASSETS_DIR, "splits")):
        for fn in os.listdir(os.path.join(ds.ASSETS_DIR, "splits", name)):
            k, repeat = fn[:-len(".json.gz")].split("shot-repeat=")
            got = ds.load_split_asset(name, int(k), repeat == "True")
            assert got == ref_ds.load_split_asset(name, int(k),
                                                  repeat == "True")
    assert ds.load_split_asset("NCaltech101", 4, True) is None


class _Far:
    """A shift range wide enough to push whole streams out of frame, so
    the reader's resample-on-empty branch runs."""
    max_shift = 300


READERS = {
    # name: (port class, JAX class, tree, sub-root, kwargs)
    "caltech-test": ("NCaltech101", "caltech", "testing", {}),
    "caltech-seeded-2shot": ("NCaltech101", "caltech", "training",
                             dict(augmentation=True, num_shots=2)),
    "caltech-seeded-9shot-repeat": ("NCaltech101", "caltech", "training",
                                    dict(num_shots=9)),
    "caltech-seeded-9shot-no-repeat": ("NCaltech101", "caltech", "training",
                                       dict(num_shots=9, repeat=False)),
    "caltech-shipped-2shot": ("NCaltech101", "shipped", "training",
                              dict(augmentation=True, num_shots=2)),
    "caltech-resample-on-empty": ("far", "caltech", "training",
                                  dict(augmentation=True)),
    "cars-seeded-3shot": ("NCars", "cars", "train",
                          dict(augmentation=True, num_shots=3)),
    "cars-test": ("NCars", "cars", "test", {}),
    "nin-train": ("NImageNet", "nin", "extracted_train",
                  dict(augmentation=True)),
    "nin-val": ("NImageNet", "nin", "extracted_val", {}),
    "mini-shipped-1shot": ("NImageNetMini", "mini", "extracted_train",
                           dict(augmentation=True, num_shots=1)),
    "mini-val": ("NImageNetMini", "mini", "extracted_val", {}),
}


def _reader_pair(trees, name):
    cls, tree, sub, kwargs = READERS[name]
    if cls == "far":
        port = type("Far", (_Far, ds.NCaltech101), {})
        ref = type("Far", (_Far, ref_ds.NCaltech101), {})
    else:
        port, ref = getattr(ds, cls), getattr(ref_ds, cls)
    root = os.path.join(trees[tree], sub)
    return port(root, **kwargs), ref(root, **kwargs)


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_equals_jax(trees, name):
    got, want = _reader_pair(trees, name)
    assert got.classes == want.classes
    np.testing.assert_array_equal(got.labeled_files, want.labeled_files)
    np.testing.assert_array_equal(got.labels, want.labels)
    assert len(got) == len(want) > 0
    for attr in ("resolution", "max_t", "max_n", "max_shift", "flip_time"):
        assert getattr(got, attr) == getattr(want, attr), attr
    resampled = 0
    for epoch in (0, 1):
        got.set_epoch(epoch)
        want.set_epoch(epoch)
        for idx in range(min(len(got), 12)):
            a, b = got[idx], want[idx]
            assert a.keys() == b.keys()
            assert a["label"] == b["label"] and a["data_idx"] == b["data_idx"]
            assert a["events"].dtype == b["events"].dtype == np.float32
            np.testing.assert_array_equal(a["events"], b["events"])
            resampled += a["data_idx"] != idx
    assert (resampled > 0) == (name == "caltech-resample-on-empty")


def test_shipped_split_branch_is_taken(trees):
    got, _ = _reader_pair(trees, "caltech-shipped-2shot")
    split = ds.load_split_asset("NCaltech101", 2, True)
    assert len(got) == len(split) == 202
    np.testing.assert_array_equal(got.labels, list(split.values()))
    assert "airplane" in got.classes and "face" in got.classes


def test_load_event_npz_fast_and_numpy_paths_equal(trees, tmp_path,
                                                   monkeypatch):
    path = os.path.join(trees["nin"], "extracted_val", os.listdir(
        os.path.join(trees["nin"], "extracted_val"))[0])
    path = os.path.join(path, os.listdir(path)[0])
    fast = ds.load_event_npz(path)
    assert ds._read_npz_member(path, "event_data.npy") is not None
    np.testing.assert_array_equal(fast, ref_ds.load_event_npz(path))
    with np.load(path) as z:
        packed = str(tmp_path / "compressed.npz")
        np.savez_compressed(packed, event_data=z["event_data"])
    assert ds._read_npz_member(packed, "event_data.npy") is None
    np.testing.assert_array_equal(ds.load_event_npz(packed), fast)
    monkeypatch.setenv("EVENTCLIP_NO_FAST_NPZ", "1")
    assert ds._read_npz_member(path, "event_data.npy") is None
    slow = ds.load_event_npz(path)
    assert slow.dtype == fast.dtype == np.float32
    np.testing.assert_array_equal(slow, fast)
    empty = str(tmp_path / "empty.npz")
    np.savez(empty, event_data=np.zeros(0, NPZ_DTYPE))
    for module in (ds, ref_ds):
        with pytest.raises(ValueError, match="empty event_data"):
            module.load_event_npz(empty)


BUILDS = {
    "n_caltech": ("configs/fsclip/joint_adapter/"
                  "joint_fsclip_ncaltech_params.py", "caltech", {}),
    "n_caltech-2shot": ("configs/fsclip/joint_adapter/"
                        "joint_fsclip_ncaltech_params.py", "shipped",
                        dict(num_shots=2)),
    "n_cars": ("configs/fsclip/joint_adapter/joint_fsclip_ncars_params.py",
               "cars", {}),
    "n_imagenet": ("configs/fsclip/joint_adapter/joint_fsclip_nin_params.py",
                   "nin", {}),
    "n_imagenet_mini": ("configs/fsclip/joint_adapter/"
                        "joint_fsclip_nin_mini_params-vitb32.py", "mini",
                        dict(num_shots=1)),
}


def _params(trees, name):
    cfg, tree, over = BUILDS[name]
    pair = (load_params(os.path.join(ROOT, cfg)),
            ref_load_params(os.path.join(ROOT, cfg)))
    for p in pair:
        p.data_root = trees[tree]
        for k, v in over.items():
            setattr(p, k, v)
    return pair


def _assert_window_sets_equal(got, want, n=6):
    assert len(got) == len(want)
    assert got.classes == want.classes
    assert (got.window, got.max_imgs, got.augment, got.tta) == (
        want.window, want.max_imgs, want.augment, want.tta)
    assert got.raster_args == want.raster_args
    for idx in range(min(len(got), n)):
        a, b = got[idx], want[idx]
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("name", sorted(BUILDS))
def test_build_dataset_equals_jax(trees, name):
    p, ref_p = _params(trees, name)
    train, val = ds.build_dataset(p)
    ref_train, ref_val = ref_ds.build_dataset(ref_p)
    _assert_window_sets_equal(train, ref_train)
    _assert_window_sets_equal(val, ref_val)
    assert val.max_imgs == ref_val.max_imgs
    _assert_window_sets_equal(ds.build_dataset(p, val_only=True),
                              ref_ds.build_dataset(ref_p, val_only=True))


def test_nin_robustness_subset_equals_jax(trees):
    p, ref_p = _params(trees, "n_imagenet")
    got = ds.build_dataset(p, val_only=True, subset=1)
    assert got.event_dataset.root.endswith("extracted_val_mode_1")
    _assert_window_sets_equal(got, ref_ds.build_dataset(ref_p, val_only=True,
                                                        subset=1))


@pytest.mark.parametrize("name", ["n_caltech", "n_imagenet"])
def test_tta_items_equal_jax(trees, name):
    p, ref_p = _params(trees, name)
    got = ds.build_dataset(p, gen_data=True, tta=True)
    want = ref_ds.build_dataset(ref_p, gen_data=True, tta=True)
    item = got[0]
    assert item["windows"].shape == (4, got.max_imgs, got.window, 3)
    assert item["valid_mask"].shape == (4, got.max_imgs)
    _assert_window_sets_equal(got, want)


def test_tta_refusals_and_keep_events_equal_jax(trees):
    root = os.path.join(trees["caltech"], "training")
    q = dict(N=1000, max_imgs=2)
    for readers, windows in ((ds, ew), (ref_ds, ref_ew)):
        with pytest.raises(AssertionError):
            windows.EventWindowDataset(
                readers.NCaltech101(root, augmentation=True), q, tta=True)
        with pytest.raises(AssertionError):
            windows.EventWindowDataset(readers.NCaltech101(root), q,
                                       augment=True, tta=True)
        with pytest.raises(AssertionError):
            windows.EventWindowDataset(
                readers.NCaltech101(root, num_shots=1), q, tta=True)
    got = ew.EventWindowDataset(ds.NCaltech101(root), q)
    want = ref_ew.EventWindowDataset(ref_ds.NCaltech101(root), q)
    got.keep_events = want.keep_events = True
    a, b = got[3], want[3]
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_split_asset_files_are_gzip_json():
    path = os.path.join(ds.ASSETS_DIR, "splits", "NCars",
                        "10shot-repeat=False.json.gz")
    with gzip.open(path, "rt") as f:
        assert json.load(f) == ds.load_split_asset("NCars", 10, False)
