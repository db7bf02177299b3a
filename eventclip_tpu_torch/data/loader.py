"""Batching, prefetching and view packing.

Port of eventclip_tpu/data/loader.py: `collate`, the threaded
`PrefetchLoader` (each rank of a data-parallel run loads its shard of
every global batch: the DistributedSampler contract), `device_prefetch`
and `adaptive_prefetch`, and the view packing of evaluation and serving
(ranks agree on the packing bucket before any array is formed).
"""

from __future__ import annotations

import math
import os
import queue
import statistics
import threading
import time
from collections import deque
from typing import Any, Dict, Iterator, List, Optional

import numpy as np


def device_prefetch(host_batches, place, depth: int = 2):
    """Place host batches on the device `depth - 1` batches ahead of the
    consumer: each placement happens right after the consumer dispatched
    its (asynchronous) step on the previous batch, so the host-to-device
    copy of batch k+1 is queued while the card runs step k."""
    buf = deque()
    for batch in host_batches:
        buf.append(place(batch))
        if len(buf) >= depth:
            yield buf.popleft()
    while buf:
        yield buf.popleft()


def adaptive_prefetch(host_batches, place, choice: Optional[dict] = None,
                      warmup: int = 2, probe: int = 4):
    """device_prefetch whose depth is measured, not assumed.

    The first `warmup` steps run untimed, the next `probe` steps at depth
    2, the `probe` after at depth 1, and the median-faster depth is stored
    in ``choice['depth']`` and used for every step after; later epochs
    (the trainer passes a persistent dict) skip straight to the winner.
    Epochs too short to finish the A/B stay at the depth-1 tail and leave
    the choice open.
    """
    if choice is None:
        choice = {}
    if choice.get("depth"):
        yield from device_prefetch(host_batches, place, choice["depth"])
        return

    it = iter(host_batches)
    buf: deque = deque()
    times = {1: [], 2: []}
    step = 0
    exhausted = False
    t_prev = None
    while True:
        if choice.get("depth"):
            mode = choice["depth"]
        else:
            mode = 2 if step < warmup + probe else 1
        while not exhausted and len(buf) < mode:
            try:
                buf.append(place(next(it)))
            except StopIteration:
                exhausted = True
        if not buf:
            return
        yield buf.popleft()
        now = time.perf_counter()
        if t_prev is not None and step >= warmup and not choice.get("depth"):
            times[mode].append(now - t_prev)
        t_prev = now
        step += 1
        if (not choice.get("depth") and len(times[1]) >= probe
                and len(times[2]) >= probe):
            choice["depth"] = (1 if statistics.median(times[1])
                               <= statistics.median(times[2]) else 2)


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


def eval_pack_buckets(batch_size: int, max_imgs: int, n_data: int,
                      num_shards: int = 1) -> Optional[List[int]]:
    """The one policy for when/how eval view-packing applies: None (padded
    eval) only when EVENTCLIP_NO_PACK_EVAL is set; buckets are multiples of
    lcm(8, n_data). Multi-process runs pack too (`pack_view_batch` agrees
    on the bucket); num_shards divides n_data, so each rank's slice of a
    bucket is whole."""
    if os.environ.get("EVENTCLIP_NO_PACK_EVAL"):
        return None
    return view_pack_buckets(batch_size * max_imgs,
                             align=math.lcm(8, max(n_data, 1)))


def pack_view_batch(batch: Dict[str, np.ndarray],
                    buckets: List[int],
                    shard_index: int = 0,
                    num_shards: int = 1) -> Dict[str, np.ndarray]:
    """Compact a padded-view batch so only REAL views get encoded.

    In: 'windows' [B, T, N, ...] + 'valid_mask' [B, T], this rank's shard
    of the global batch. Out: the same dict with 'windows'
    [K/num_shards, N, ...] holding this shard's valid views and 'view_src'
    [K/num_shards] int32 GLOBAL flat [B_global*T] slot ids (sentinel
    B_global*T = packing padding), as the JAX function gives them (the
    eval step maps them to its local batch). K is the smallest bucket
    whose per-shard slice fits every rank's view count, agreed with one
    host-side max over the ranks; a batch needing more views than
    max(buckets) is returned unpacked on every rank (the padded forward
    is always correct). Consumed by
    models.classifier.classifier_forward_packed.
    """
    valid = np.asarray(batch["valid_mask"], dtype=bool)
    B, T = valid.shape
    idx = np.flatnonzero(valid.reshape(-1)).astype(np.int32)
    need = max(len(idx), 1)
    if num_shards > 1:
        from ..parallel import distributed

        need = int(distributed.allreduce_max_array(
            np.asarray([need], dtype=np.int64))[0])
    fitting = [k for k in buckets if k // num_shards >= need]
    if not fitting:
        return batch
    K = fitting[0] // num_shards  # this rank's slice of the packed axis
    windows = np.asarray(batch["windows"])
    flat = windows.reshape((B * T,) + windows.shape[2:])
    packed = np.zeros((K,) + flat.shape[1:], dtype=flat.dtype)
    packed[: len(idx)] = flat[idx]
    src = np.full((K,), num_shards * B * T, dtype=np.int32)
    src[: len(idx)] = idx + shard_index * B * T
    out = dict(batch)
    out["windows"] = packed
    out["view_src"] = src
    return out


def collate(items: List[Dict[str, Any]]) -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for k in items[0]:
        vals = [it[k] for it in items]
        if np.isscalar(vals[0]) or np.ndim(vals[0]) == 0:
            out[k] = np.asarray(vals)
        else:
            out[k] = np.stack(vals)
    return out


class PrefetchLoader:
    """Threaded batch loader: worker threads build batches ahead of the
    consumer (numpy releases the GIL in its bulk work), yielded strictly
    in order. Epochs are seeded: `loader.epoch(k)` reshuffles
    deterministically. With `num_shards` > 1 this loader yields rank
    `shard_index`'s slice of every global batch of `batch_size`."""

    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = False,
        drop_last: bool = False,
        num_workers: int = 4,
        prefetch: int = 4,
        seed: int = 0,
        shard_index: int = 0,
        num_shards: int = 1,
        pad_last: bool = False,
    ):
        """pad_last: repeat-pad the final ragged batch to batch_size and add
        a 'sample_mask' key (static shapes; masked in eval)."""
        assert not (drop_last and pad_last)
        assert batch_size % num_shards == 0, (batch_size, num_shards)
        self.dataset = dataset
        self.batch_size = batch_size
        self.local_batch = batch_size // num_shards
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.pad_last = pad_last
        self.num_workers = max(num_workers, 1)
        self.prefetch = max(prefetch, 1)
        self.seed = seed
        self.shard_index = shard_index
        self.num_shards = num_shards
        self._epoch = 0

    def epoch(self, k: int) -> "PrefetchLoader":
        self._epoch = k
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(k)
        return self

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def _order(self) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            rng = np.random.default_rng((self.seed, self._epoch))
            rng.shuffle(idx)
        return idx

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        order = self._order()
        # (this shard's slice, fallback index) of every global batch: a
        # ragged final global batch can leave a trailing shard with NO
        # items; it still emits a lockstep batch (collectives), padded
        # from a sample of the global batch with every row masked out
        jobs = []
        lo = self.shard_index * self.local_batch
        for b in range(len(self)):
            sl = order[b * self.batch_size:(b + 1) * self.batch_size]
            jobs.append((sl[lo:lo + self.local_batch], int(sl[0])))
        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        lock = threading.Lock()
        next_job = [0]

        def worker():
            while not stop.is_set():
                with lock:
                    j = next_job[0]
                    if j >= len(jobs):
                        return
                    next_job[0] += 1
                try:
                    batch = self._make_batch(jobs[j])
                except BaseException as e:  # surfaced in the consumer
                    batch = e
                while not stop.is_set():
                    try:
                        out_q.put((j, batch), timeout=0.1)
                        break
                    except queue.Full:
                        continue

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(min(self.num_workers, max(len(jobs), 1)))]
        for t in threads:
            t.start()
        # consumer-side reordering: drain unconditionally (no deadlock),
        # yield strictly in batch order
        pending: Dict[int, Any] = {}
        try:
            for want in range(len(jobs)):
                while want not in pending:
                    j, batch = out_q.get()
                    pending[j] = batch
                item = pending.pop(want)
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()

    def _make_batch(self, job) -> Dict[str, np.ndarray]:
        idxs, fallback = job
        items = [self.dataset[int(i)] for i in idxs]
        n = len(items)
        if n == 0 and not self.pad_last:
            raise ValueError(
                f"shard {self.shard_index}/{self.num_shards} got 0 of "
                f"{self.local_batch} items for the final ragged batch; "
                "use pad_last=True (eval) or drop_last=True (train)")
        if self.pad_last and n < self.local_batch:
            pad_src = items[-1] if items else self.dataset[fallback]
            items = items + [pad_src] * (self.local_batch - n)
        batch = collate(items)
        if self.pad_last:
            mask = np.zeros(self.local_batch, dtype=bool)
            mask[:n] = True
            batch["sample_mask"] = mask
        return batch
