"""The port's dataset wrapper and loaders vs the JAX package's.

One stub event dataset (items made from (seed, epoch, idx), centred like
the dataset readers') feeds both packages' `EventWindowDataset`; their
items and the batches of their `PrefetchLoader`s — order under shuffling,
the dropped or repeat-padded last batch, `sample_mask` — must be equal,
array for array.
"""

import numpy as np
import pytest
import torch

from eventclip_tpu.data import loader as ref_loader
from eventclip_tpu.data.event_windows import (
    EventWindowDataset as RefEventWindowDataset,
)
from eventclip_tpu_torch.data import loader
from eventclip_tpu_torch.data.event_windows import EventWindowDataset
from eventclip_tpu_torch.data.host_ops import prepare_stream
from eventclip_tpu_torch.utils.meters import AverageMeter

QUANT = dict(N=300, max_imgs=3, split_method="event_count",
             convert_method="event_histogram", grayscale=True)


class StubEvents:
    """A tiny event dataset: 40 x 50 frames, 100-1300 events per item."""

    resolution = (40, 50)
    max_t = 0.1
    max_n = 900
    augmentation = False
    num_shots = None
    root = "stub/train"

    def __init__(self, n=11, seed=0):
        self.n, self.seed, self.epoch = n, seed, 0
        self.classes = [f"c{i}" for i in range(4)]

    def __len__(self):
        return self.n

    def set_epoch(self, epoch):
        self.epoch = epoch

    def __getitem__(self, idx):
        rng = np.random.default_rng((self.seed, self.epoch, idx))
        n = int(rng.integers(100, 1300))
        ev = np.stack([rng.integers(0, 50, n), rng.integers(0, 40, n),
                       np.sort(rng.uniform(0, 0.1, n)),
                       rng.choice([-1.0, 1.0], n)], 1).astype(np.float32)
        return {"events": prepare_stream(ev, self.resolution),
                "label": idx % 4, "data_idx": idx}


def _assert_items_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]),
                                      err_msg=k)


@pytest.mark.parametrize("epoch", [0, 3])
def test_event_window_dataset_equals_jax(epoch):
    got_ds = EventWindowDataset(StubEvents(), QUANT, seed=5)
    want_ds = RefEventWindowDataset(StubEvents(), QUANT, seed=5)
    assert (got_ds.window, got_ds.max_imgs, got_ds.raster_args) == (
        want_ds.window, want_ds.max_imgs, want_ds.raster_args)
    assert got_ds.classes == want_ds.classes and len(got_ds) == len(want_ds)
    got_ds.set_epoch(epoch)
    want_ds.set_epoch(epoch)
    for idx in range(len(got_ds)):
        item = got_ds[idx]
        assert item["windows"].dtype == np.int16
        assert item["windows"].shape == (3, 300, 3)
        _assert_items_equal(item, want_ds[idx])


@pytest.mark.parametrize("kw", [
    dict(shuffle=True, drop_last=True),
    dict(shuffle=True),
    dict(shuffle=False, pad_last=True),
])
def test_prefetch_loader_batches_equal_jax(kw):
    got_ds = EventWindowDataset(StubEvents(), QUANT)
    want_ds = RefEventWindowDataset(StubEvents(), QUANT)
    got_l = loader.PrefetchLoader(got_ds, 4, num_workers=3, seed=7, **kw)
    want_l = ref_loader.PrefetchLoader(want_ds, 4, num_workers=3, seed=7,
                                       **kw)
    assert len(got_l) == len(want_l) == (2 if kw.get("drop_last") else 3)
    for epoch in (0, 1):
        got = list(got_l.epoch(epoch))
        want = list(want_l.epoch(epoch))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_items_equal(g, w)
    if kw.get("pad_last"):
        last = got[-1]
        assert last["windows"].shape[0] == 4
        np.testing.assert_array_equal(last["sample_mask"],
                                      [True, True, True, False])


def test_loader_surfaces_worker_errors():
    class Broken(StubEvents):
        def __getitem__(self, idx):
            if idx == 5:
                raise RuntimeError("bad item")
            return super().__getitem__(idx)

    ds = EventWindowDataset(Broken(), QUANT)
    with pytest.raises(RuntimeError, match="bad item"):
        list(loader.PrefetchLoader(ds, 2, num_workers=2))


def test_collate_and_device_prefetch_equal_jax():
    items = [{"a": np.full((2, 3), i), "label": i, "x": np.float32(i)}
             for i in range(5)]
    _assert_items_equal(loader.collate(items), ref_loader.collate(items))
    placed = []

    def place(b):
        placed.append(b)
        return torch.as_tensor(b)

    out = loader.device_prefetch(iter(range(5)), place, depth=2)
    assert int(next(out)) == 0 and placed == [0, 1]  # one batch ahead
    assert [int(x) for x in out] == [1, 2, 3, 4]


def test_average_meter():
    m = AverageMeter()
    m.update(2.0)
    m.update(4.0, n=3)
    assert (m.val, m.count, m.sum, m.avg) == (4.0, 4, 14.0, 3.5)
