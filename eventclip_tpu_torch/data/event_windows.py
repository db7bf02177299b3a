"""Config -> window geometry (port of eventclip_tpu/data/event_windows.py,
`parse_quantize_args` only; the dataset wrapper comes with the readers)."""

from __future__ import annotations

from .host_ops import max_views


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
