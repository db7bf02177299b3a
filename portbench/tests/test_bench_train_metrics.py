"""The training cell's traffic file and its metrics' arithmetic, against
numbers worked by hand."""

import os
import types

import numpy as np
import pytest

from portbench import core, devtrace, streams
from portbench.tests.tiny import BENCH_DIR

CFG = core.read_json(os.path.join(BENCH_DIR, "configs", "ft_nin_vitl14.json"))
VITL = CFG["vision"]
TRAFFIC = core.read_json(os.path.join(BENCH_DIR, "traffic",
                                      "train_b128.json"))
DRIVER = core.load_file(os.path.join(BENCH_DIR, "drivers", "train_step.py"),
                        "driver_train_step")
GEO = DRIVER.geometry(CFG)


def metric(name):
    return core.load_file(os.path.join(BENCH_DIR, "metrics", name + ".py"),
                          "metric_" + name)


# -- the traffic -------------------------------------------------------------


def test_the_cells_geometry_is_the_mirrored_configs():
    assert GEO == {"height": 480, "width": 640, "window": 70000, "views": 2,
                   "batch": 128}
    # 100 steps an epoch: more than a 51 s window holds at the card's
    # 0.83 s a step (or at 0.51), so a window sees one epoch start
    assert TRAFFIC["items"] // GEO["batch"] == 100
    assert TRAFFIC["items"] % GEO["batch"] == 0
    # the schedule: 800 steps, a 40-step warm-up
    steps = CFG["params"]["max_epochs"] * TRAFFIC["items"] // GEO["batch"]
    assert steps == 800
    assert steps * CFG["params"]["warmup_steps_pct"] == pytest.approx(40)


def test_every_recording_carries_two_full_windows():
    n = streams.lengths(TRAFFIC["events"])
    assert len(n) * TRAFFIC["copies"] == 256
    assert min(n) >= 140000 and max(n) <= 300000
    # after a shift drops the events it pushes out of the frame, a stream
    # of 1.5 windows or more still gives two full ones
    assert min(n) >= 2 * GEO["window"]


def test_recordings_and_labels_come_from_the_seed():
    small = dict(TRAFFIC, events={"min": 1000, "max": 3000, "levels": 3},
                 copies=2)
    a = DRIVER.make_recordings(small, GEO, 2 ** 33 + 1)
    b = DRIVER.make_recordings(small, GEO, 2 ** 33 + 1)
    c = DRIVER.make_recordings(small, GEO, 2 ** 33 + 2)
    assert [len(x) for x in a] == [1333, 1333, 2000, 2000, 2667, 2667]
    for x, y, z in zip(a, b, c):
        np.testing.assert_array_equal(x, y)
        assert x.shape == z.shape and not np.array_equal(x, z)
        assert (x[:, 0] < 640).all() and (x[:, 1] < 480).all()
    # the same recordings as the serving generator's pool
    pool = streams.stream_pool(small, (480, 640), 2 ** 33 + 1)
    np.testing.assert_array_equal(a[3], pool[1][1])


def test_the_reader_gives_two_full_windows_an_item():
    """The port's reader over the recordings at the cell's geometry:
    every item two valid windows of 70,000 events."""
    from eventclip_tpu_torch.data.event_windows import EventWindowDataset

    recs = DRIVER.make_recordings(dict(TRAFFIC, events={
        "min": 140000, "max": 141000, "levels": 1}), GEO, 5)
    labels = np.array([3, 7])
    ds = EventWindowDataset(DRIVER.event_dataset(recs, labels, CFG, 5),
                            CFG["params"]["quantize_args"], augment=True,
                            seed=5)
    for i in range(2):
        item = ds[i]
        assert item["windows"].shape == (2, 70000, 3)
        assert item["valid_mask"].all() and item["label"] == labels[i]
        assert (item["windows"][..., 2] != 0).all()


def test_the_reader_is_the_ports_own_over_the_same_recordings(tmp_path):
    """The cell's reader, built by NImageNet's own constructor, against a
    real NImageNet over the same recordings written to disk: the same
    state, classes, labels and items, epoch by epoch."""
    from eventclip_tpu_torch.data.datasets import (NImageNet,
                                                   imagenet_folder2name)

    rng = np.random.default_rng(3)
    wnids = list(imagenet_folder2name())[:3]
    for w in wnids:
        os.makedirs(tmp_path / "extracted_train" / w)
        for f in ("a", "b"):
            ev = np.zeros(4000, dtype=[("x", "<u2"), ("y", "<u2"),
                                       ("t", "<i8"), ("p", "?")])
            ev["x"] = rng.integers(0, 640, 4000)
            ev["y"] = rng.integers(0, 480, 4000)
            ev["t"] = np.sort(rng.integers(0, 55000, 4000))
            ev["p"] = rng.integers(0, 2, 4000).astype(bool)
            np.savez(tmp_path / "extracted_train" / w / f"{f}.npz",
                     event_data=ev)
    real = NImageNet(str(tmp_path / "extracted_train"), augmentation=True,
                     seed=11)
    recs = [NImageNet._load_events(f) for f in real.labeled_files]
    ours = DRIVER.event_dataset(recs, real.labels, dict(CFG, n_classes=3), 11)
    assert sorted(vars(ours)) == sorted(vars(real))
    for k in ("augmentation", "num_shots", "few_shot", "repeat", "_seed",
              "is_pseudo", "resolution", "max_t", "max_n", "max_shift",
              "flip_time"):
        assert getattr(ours, k) == getattr(real, k), k
    assert ours.classes == real.classes
    np.testing.assert_array_equal(ours.labels, real.labels)
    for epoch in (0, 3):
        ours.set_epoch(epoch)
        real.set_epoch(epoch)
        for i in range(len(real)):
            a, b = ours[i], real[i]
            np.testing.assert_array_equal(a["events"], b["events"])
            assert (a["label"], a["data_idx"]) == (b["label"], b["data_idx"])


# -- the metrics -------------------------------------------------------------


def test_k3_bound_at_the_training_shape():
    # q, k, v and the output gradient in, the q/k/v gradient out: 7 bf16
    # [256, 257, 1024] tensors, 943.2 MB at 3.35 TB/s; the 5 products'
    # 173 GFLOP would take 0.175 ms at 989 TFLOP/s
    k3 = metric("k3_roofline.train")
    assert 7 * 256 * 257 * 1024 * 2 == 943194112
    assert k3.k3_bound_s(256, VITL) * 1e3 == pytest.approx(0.2816, abs=5e-5)


def test_d1_bound_a_launch_at_m_65792():
    # (K, N) (1024, 3072), (1024, 1024), (1024, 4096), (4096, 1024) at
    # M = 256 x 257 = 65,792, each bound by its operations: 0.4185 +
    # 0.1395 + 0.5580 + 0.5580 ms, a launch their mean
    d1 = metric("dense_roofline.train")
    assert 256 * 257 == 65792
    assert 2 * 65792 * 1024 * 3072 / 989e12 * 1e3 == pytest.approx(
        0.4185, abs=5e-5)
    assert d1.launch_bound_s(256, VITL) * 1e3 == pytest.approx(
        (0.4185 + 0.1395 + 0.5580 + 0.5580) / 4, abs=1e-4)


def test_mfu_counts_three_forwards_a_view_a_step():
    mfu = metric("mfu.train")
    assert mfu.step_flops(VITL, 256) / 1e12 == pytest.approx(
        3 * 161.98e9 * 256 / 1e12, rel=1e-3)
    ctx = types.SimpleNamespace(config=CFG, geometry=GEO, window_s=51.0,
                                steps=[(0.01, 0.68)] * 75)
    want = 100 * 75 * 3 * 161.98e9 * 256 / (51.0 * 989e12)
    assert mfu.read(ctx) == pytest.approx(want, rel=1e-3)


def test_rooflines_count_every_launch_of_the_trace():
    k3 = metric("k3_roofline.train")
    t = k3.k3_bound_s(256, VITL)
    # each pair twice its bound: dq and dk/dv kernels of one launch
    kern = [("dq_wgmma_kernel<64>", i, 0.5 * t) for i in range(24)] + \
        [("dkdv_wgmma_kernel<64>", 30 + i, 1.5 * t) for i in range(24)]
    ctx = types.SimpleNamespace(config=CFG, geometry=GEO, steps=[(0, 1)],
                                trace=devtrace.Trace(kern, [], (0.0, 60.0)))
    assert k3.read(ctx) == pytest.approx(50.0)
    k2 = metric("k2_roofline.train")
    b2 = core.load_file(os.path.join(BENCH_DIR, "metrics",
                                     "k2_roofline.batch.py"),
                        "metric_k2_roofline.batch").k2_bound_s(256, VITL)
    ctx.trace = devtrace.Trace([("attention_wgmma_kernel", i, 4 * b2)
                                for i in range(48)], [], (0.0, 60.0))
    assert k2.read(ctx) == pytest.approx(25.0)
    d1 = metric("dense_roofline.train")
    b1 = d1.launch_bound_s(256, VITL)
    ctx.trace = devtrace.Trace([("dense_wgmma_kernel", i, b1 / 0.75)
                                for i in range(192)], [], (0.0, 60.0))
    assert d1.read(ctx) == pytest.approx(75.0)
    ctx.trace = devtrace.Trace([], [], (0.0, 1.0))
    for m in (k2, k3, d1):  # no kernel read: no number, never 0
        assert m.read(ctx) is None


def test_step_metrics_are_means_of_the_trainers_record():
    ctx = types.SimpleNamespace(
        steps=[(0.010, 0.700), (0.030, 0.660)],
        trace=devtrace.Trace([("k", 0.0, 3.0), ("randaugment", 0.5, 0.020),
                              ("randaugment", 2.5, 0.024)], [], (0.0, 4.0)))
    assert metric("loader_wait_ms.train").read(ctx) == pytest.approx(20.0)
    assert metric("step_ms.train").read(ctx) == pytest.approx(680.0)
    assert metric("randaugment_ms.train").read(ctx) == pytest.approx(22.0)
    assert metric("idle_share.train").read(ctx) == pytest.approx(25.0)
    empty = types.SimpleNamespace(steps=[], trace=None)
    for name in ("loader_wait_ms.train", "step_ms.train",
                 "randaugment_ms.train", "idle_share.train"):
        assert metric(name).read(empty) is None


def test_idle_share_does_not_count_a_ranges_row_as_device_work():
    # kernels at [0, 1) and [2, 3); the program's `randaugment` range row
    # spans [0.5, 2.5), over the gap between them: 2 s busy of 4, where
    # the trace's own union (the range row counted) reads 3
    trace = devtrace.Trace([("a", 0.0, 1.0), ("randaugment", 0.5, 2.0),
                            ("b", 2.0, 1.0), ("text_feats", 3.5, 0.4)],
                           [], (0.0, 4.0))
    ctx = types.SimpleNamespace(steps=[(0.0, 1.0)], trace=trace)
    assert trace.busy_s == pytest.approx(3.4)
    assert metric("idle_share.train").read(ctx) == pytest.approx(50.0)
    # clipped to the window
    ctx.trace = devtrace.Trace([("a", -1.0, 2.0), ("b", 3.0, 5.0)], [],
                               (0.0, 4.0))
    assert metric("idle_share.train").read(ctx) == pytest.approx(50.0)
    assert metric("randaugment_ms.train").read(
        types.SimpleNamespace(trace=trace)) == pytest.approx(2000.0)


def test_the_window_ends_before_the_first_step_due_after_its_time():
    """Epochs as `train_epoch` runs them, the window ended inside the
    second: every step that ran counts, none after the deadline runs, and
    the loader's threads are waited for."""
    import threading
    import time

    import torch

    class Trainer:
        ran = []

        def train_step(self, batch):
            self.ran.append(batch)
            time.sleep(0.02)
            return {"total_loss": torch.tensor(1.0)}

        def train_epoch(self, epoch):
            self.step_times = []
            worker = threading.Thread(target=time.sleep, args=(0.05,))
            worker.start()
            for i in range(5):
                t = time.perf_counter()
                self.train_step((epoch, i))
                self.step_times.append((0.0, time.perf_counter() - t))

    tr = Trainer()
    state = types.SimpleNamespace(trainer=tr, epoch=1)
    before = threading.active_count()
    win = DRIVER.run_window(state, 0.15, devtrace.Spans())
    assert 0.15 <= win.window_s < 0.15 + 0.02 + 0.01
    assert win.attempted == len(win.steps) == len(tr.ran)
    assert 6 <= win.attempted <= 8 and win.failed == 0
    assert tr.ran[:6] == [(1, i) for i in range(5)] + [(2, 0)]
    assert tr.train_step.__func__ is Trainer.train_step
    assert threading.active_count() <= before


def test_the_rate_is_every_step_over_the_whole_window():
    win = DRIVER.Window(steps=[], window_s=51.2, attempted=75, failed=1)
    state = types.SimpleNamespace(geometry=GEO)
    assert DRIVER.end_to_end(state, win) == {
        "train_samples_per_s": pytest.approx(128 * 75 / 51.2)}
