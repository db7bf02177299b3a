"""Data parallelism over the local cards of one process.

The counterpart of the JAX package's `make_mesh()` over every local
device with `shard_batch` (serve.py's `data_parallel=True`, the root
test.py's and gen_data.py's meshes): the model is replicated once on each
card of an explicit device list, every eval batch is cut into equal
parts along its leading dim (the packed views, or the samples of a padded
batch), each part is rasterized (K1) and encoded on its own card, every
part launched before the first synchronize, and the view features come
back, in order, to the first card, which runs the head. A list that
names one device twice runs both parts on it (how one card checks the
split); `["cpu", "cpu"]` runs it on the CPU.

Batch sizes must split: the callers round them to a multiple of the
part count, and the eval packing buckets are multiples of lcm(8, parts)
(`data.loader.eval_pack_buckets`), as the JAX package's are of the data
axis. A list of one device is the unsplit forward (serve.py's Predictor
and the gen_data teacher run every batch through a split).
"""

from __future__ import annotations

import copy
from typing import Callable, Dict, List, Optional, Sequence

import torch
from torch import nn

from ..models.classifier import (_encode_views, classifier_head,
                                 classifier_head_packed)
from ..ops.rasterize import rasterize_for_clip


def local_devices(device) -> List[torch.device]:
    """Every visible card when `device` is a card, else [device]."""
    device = torch.device(device)
    if device.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [device]


class LocalSplit:
    """`params` (a ClassifierParams) replicated once on each of `devices`
    (a device named again shares the replica made for it); the first
    device holds the caller's module and runs the head."""

    def __init__(self, params: nn.Module, devices: Sequence):
        self.devices = [torch.device(d) for d in devices]
        if not self.devices:
            raise ValueError("a local split needs at least one device")
        made: Dict[torch.device, nn.Module] = {self.devices[0]: params}
        for d in self.devices[1:]:
            if d not in made:
                made[d] = copy.deepcopy(params).to(d)
        self.replicas = [made[d] for d in self.devices]

    @property
    def n(self) -> int:
        return len(self.devices)

    @property
    def params(self) -> nn.Module:
        return self.replicas[0]

    def update(self, fn: Callable[[nn.Module, torch.device], None]) -> None:
        """fn(replica, device) on every distinct replica (e.g. a label
        swap's new text features)."""
        seen = set()
        for r, d in zip(self.replicas, self.devices):
            if id(r) not in seen:
                seen.add(id(r))
                fn(r, d)

    def _encode(self, cfg, spec, pp, parts: List[torch.Tensor]
                ) -> torch.Tensor:
        """Each part's windows rasterized and encoded on its card (all
        launched first), the [rows, C] features concatenated in order on
        the first card."""
        feats = []
        for r, d, w in zip(self.replicas, self.devices, parts):
            w = w.to(d, non_blocking=True)
            imgs = rasterize_for_clip(spec, pp, w)
            feats.append(_encode_views(
                r, cfg, imgs.reshape((-1,) + tuple(imgs.shape[-3:])),
                train=False))
        head = self.devices[0]
        return torch.cat([f.to(head) for f in feats])

    @torch.inference_mode()
    def forward(self, cfg, spec, pp, windows: torch.Tensor,
                valid: torch.Tensor,
                view_src: Optional[torch.Tensor] = None
                ) -> Dict[str, torch.Tensor]:
        """The eval forward over the split: packed ([K, N, c] windows with
        `view_src`, K cut into equal parts) or padded ([B, T, N, c], the B
        samples cut). `valid` and `view_src` are read on the first card."""
        head = self.devices[0]
        valid = valid.to(head)
        lead = windows.shape[0]
        if lead % self.n:
            raise ValueError(f"a batch of {lead} rows does not split into "
                             f"{self.n} equal parts")
        feats = self._encode(cfg, spec, pp, list(windows.chunk(self.n)))
        if view_src is not None:
            return classifier_head_packed(self.params, cfg, feats,
                                          view_src.to(head), valid)
        return classifier_head(self.params, cfg, feats, valid)
