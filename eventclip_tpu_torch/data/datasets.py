"""Sensor statistics by dataset name.

Port of the `DATASET_CLASSES` table of eventclip_tpu/data/datasets.py: the
resolution and `max_n` that serving needs without a dataset tree on disk
(reference datasets/caltech.py:52-58, cars.py, imagenet.py). The dataset
readers themselves come in a later slice.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class SensorStats:
    resolution: Tuple[int, int]  # (H, W)
    max_n: int  # events per recording the view budget is sized for


DATASET_CLASSES = {
    "n_caltech": SensorStats((180, 240), 225000),
    "n_cars": SensorStats((100, 120), 12500),
    "n_imagenet": SensorStats((480, 640), 135000),
    "n_imagenet_mini": SensorStats((480, 640), 135000),
}
