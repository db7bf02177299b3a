"""View packing for evaluation and serving.

Port of `view_pack_buckets`, `eval_pack_buckets` and `pack_view_batch` from
eventclip_tpu/data/loader.py, single-process: the cross-host agreement on
the bucket (an allgather) comes with multi-GPU work.
"""

from __future__ import annotations

import math
import os
from typing import Dict, List, Optional

import numpy as np


def view_pack_buckets(total_views: int, align: int = 8) -> List[int]:
    """Static view-count buckets for packed eval (quarters of the budget).

    A batch's packed view count K is rounded UP to the smallest bucket, so
    at most four encoder shapes ever run. Every bucket is a multiple of
    `align`, so the top bucket may exceed total_views by up to align-1
    blank slots.
    """
    align = max(int(align), 1)
    out = []
    for frac in (0.25, 0.5, 0.75, 1.0):
        k = int(np.ceil(total_views * frac / align)) * align
        out.append(max(k, align))
    return sorted(set(out))


def eval_pack_buckets(batch_size: int, max_imgs: int,
                      n_data: int) -> Optional[List[int]]:
    """The one policy for when/how eval view-packing applies: None (padded
    eval) only when EVENTCLIP_NO_PACK_EVAL is set; buckets are multiples of
    lcm(8, n_data)."""
    if os.environ.get("EVENTCLIP_NO_PACK_EVAL"):
        return None
    return view_pack_buckets(batch_size * max_imgs,
                             align=math.lcm(8, max(n_data, 1)))


def pack_view_batch(batch: Dict[str, np.ndarray],
                    buckets: List[int]) -> Dict[str, np.ndarray]:
    """Compact a padded-view batch so only REAL views get encoded.

    In: 'windows' [B, T, N, ...] + 'valid_mask' [B, T]. Out: the same dict
    with 'windows' [K, N, ...] holding the valid views and 'view_src' [K]
    int32 flat [B*T] slot ids (sentinel B*T = packing padding). K is the
    smallest bucket that fits the view count; a batch needing more views
    than max(buckets) is returned unpacked (the padded forward is always
    correct). Consumed by models.classifier.classifier_forward_packed.
    """
    valid = np.asarray(batch["valid_mask"], dtype=bool)
    B, T = valid.shape
    idx = np.flatnonzero(valid.reshape(-1)).astype(np.int32)
    need = max(len(idx), 1)
    fitting = [k for k in buckets if k >= need]
    if not fitting:
        return batch
    K = fitting[0]
    windows = np.asarray(batch["windows"])
    flat = windows.reshape((B * T,) + windows.shape[2:])
    packed = np.zeros((K,) + flat.shape[1:], dtype=flat.dtype)
    packed[: len(idx)] = flat[idx]
    src = np.full((K,), B * T, dtype=np.int32)
    src[: len(idx)] = idx
    out = dict(batch)
    out["windows"] = packed
    out["view_src"] = src
    return out
