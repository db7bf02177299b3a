"""Host half of the pipeline: event streams -> packed windows -> batches."""

from .host_ops import (
    center_events,
    shift_events,
    hflip_events,
    tflip_events,
    gather_event_windows,
    max_views,
    prepare_stream,
    tta_variants,
)
from .datasets import (
    NCaltech101,
    NCars,
    NImageNet,
    NImageNetMini,
    MINI_NAMES,
    NIN_VAL_SUBSETS,
    build_dataset,
    build_n_caltech_dataset,
    build_n_cars_dataset,
    build_n_imagenet_dataset,
    build_n_imagenet_mini_dataset,
)
from .event_windows import EventWindowDataset
from .loader import (PrefetchLoader, adaptive_prefetch, collate,
                     device_prefetch)

__all__ = [
    "center_events",
    "shift_events",
    "hflip_events",
    "tflip_events",
    "gather_event_windows",
    "max_views",
    "prepare_stream",
    "tta_variants",
    "NCaltech101",
    "NCars",
    "NImageNet",
    "NImageNetMini",
    "MINI_NAMES",
    "NIN_VAL_SUBSETS",
    "build_dataset",
    "build_n_caltech_dataset",
    "build_n_cars_dataset",
    "build_n_imagenet_dataset",
    "build_n_imagenet_mini_dataset",
    "EventWindowDataset",
    "PrefetchLoader",
    "adaptive_prefetch",
    "collate",
    "device_prefetch",
]
