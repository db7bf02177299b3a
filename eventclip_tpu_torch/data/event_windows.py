"""Event -> padded-window pipeline (the host half of Event2ImageDataset).

Port of eventclip_tpu/data/event_windows.py. The host
only selects and pads raw event windows — packed [V, N, 3] int16 (x, y, p)
per sample, timestamps dropped because the device never reads them — and
the card turns them into CLIP inputs (ops.rasterize.rasterize_for_clip).

Behavioral contracts:
- view budget max(min(round(max_n/N), max_imgs), 1)  event2img.py:70-72
- random view subsample / zero-pad + valid_mask      event2img.py:80-92
- 4-way TTA (id, h-flip, t-flip, h+t-flip)           event2img.py:94-112
- keep_events hack for visualization                 event2img.py:74-76,137-139
"""

from __future__ import annotations

import copy
from typing import Any, Dict

import numpy as np

from .host_ops import gather_event_windows, max_views, tta_variants


def parse_quantize_args(quantize_args, resolution, max_n, hard_limit=None):
    """Split a config's quantize_args into (window, views, raster_args).

    split_method must be event_count, convert_method parameterizes nothing
    on-device, N is the events-per-window, max_imgs caps the view budget
    max(min(round(max_n/N), cap), 1) (reference event2img.py:70-72).
    `hard_limit` overrides the config's max_imgs (eval forces 10).
    """
    q = dict(quantize_args)
    split = q.pop("split_method", "event_count")
    if split != "event_count":
        raise ValueError(f"unsupported split_method {split!r}")
    q.pop("convert_method", None)
    window = int(q.pop("N"))
    cap = int(q.pop("max_imgs", 10))
    if hard_limit is not None:
        cap = hard_limit
    views = max_views(max_n, window, cap)
    raster_args = dict(height=resolution[0], width=resolution[1],
                       window=window, **q)
    return window, views, raster_args


class EventWindowDataset:
    """Wraps an event dataset (items {'events': [n, 4] centred x/y/t/p,
    'label', ...}); items are padded window tensors + masks."""

    def __init__(
        self,
        event_dataset,
        quantize_args: Dict[str, Any],
        augment: bool = False,
        tta: bool = False,
        seed: int = 0,
    ):
        self.event_dataset = event_dataset
        self.classes = event_dataset.classes
        self.resolution = event_dataset.resolution
        self.max_t = event_dataset.max_t
        self.max_n = event_dataset.max_n

        self.window, self.max_imgs, self.raster_args = parse_quantize_args(
            quantize_args, self.resolution, self.max_n
        )
        # `augment` requests image-space RandAugment, applied on the device
        # in the training step; the dataset only records the flag
        self.augment = augment

        # tta: items carry the 4 TTA variants' windows (pseudo-labelling)
        self.tta = tta
        if tta:
            assert not event_dataset.augmentation, (
                "event-space augmentation must stay off while generating "
                "pseudo labels")
            assert not augment, "image augmentation conflicts with TTA"
            assert event_dataset.num_shots is None, (
                "pseudo-labeling consumes the full training split, not a "
                "few-shot subset")
            assert "train" in event_dataset.root
        self.keep_events = False
        self._seed = seed
        self._epoch = 0

    def __len__(self) -> int:
        return len(self.event_dataset)

    def set_epoch(self, epoch: int) -> None:
        self._epoch = int(epoch)
        if hasattr(self.event_dataset, "set_epoch"):
            self.event_dataset.set_epoch(epoch)

    def raster_spec(self):
        from ..ops.rasterize import RasterSpec

        return RasterSpec(**self.raster_args)

    def _events2windows(self, events: np.ndarray, rng):
        return gather_event_windows(
            events, self.window, self.max_imgs, rng=rng, packed=True)

    def _load_tta_item(self, data: Dict[str, Any], rng) -> Dict[str, Any]:
        events = data.pop("events")
        wins, valids = zip(*[
            self._events2windows(e, rng)
            for e in tta_variants(events, self.resolution)
        ])
        data["windows"] = np.stack(wins)  # [4, V, N, 3] int16 packed
        data["valid_mask"] = np.stack(valids)  # [4, V]
        return data

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        # per-item generator: thread-safe under the PrefetchLoader and
        # deterministic given (seed, epoch, idx); the trailing stream tag
        # decorrelates it from the event dataset's own (seed, epoch, idx)
        # generator (the JAX package's exact seeding)
        rng = np.random.default_rng((self._seed, self._epoch, idx, 0xE77))
        data = self.event_dataset[idx]
        if self.tta:
            return self._load_tta_item(data, rng)
        events = data.pop("events")
        if self.keep_events:
            data["events"] = copy.deepcopy(events)
        windows, valid = self._events2windows(events, rng)
        data["windows"] = windows  # [V, N, 3] int16 packed
        data["valid_mask"] = valid  # [V]
        return data
