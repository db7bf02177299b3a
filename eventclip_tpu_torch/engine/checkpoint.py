"""Checkpointing.

Port of eventclip_tpu/engine/checkpoint.py, with the same conventions:
- checkpoints are CLIP-free: only trainable leaves are saved (the
  reference's state-dict surgery, models/clip_cls.py:208-219,
  models/clip_cls_ft.py:313-333) — here the `trainable_mask` parameters;
- a rolling `model_<step>.npz` every save plus a `best.npz` tracking the
  monitored metric's max;
- the format is the JAX package's: npz keyed by its '/'-joined tree paths,
  leaves in its shapes (stacked layers), written through
  models/clip/convert.py::to_jax_flat. So either package loads the other's
  trainable checkpoints;
- `load_checkpoint` also takes the reference's torch method checkpoints
  (`.pth` / `.pt`), converted on the fly (models/clip/convert_method.py).

Resume state (trainable leaves, the optimizer's moments and count, epoch,
best metric) uses the port's own format, `resume.pt` via torch.save: the
JAX package's `resume.pkl` pickles optax state, which has no torch
counterpart.

In a data-parallel run every rank calls the manager at the same points,
and rank 0 alone writes; every rank reads `resume.pt` after a barrier
that follows rank 0's write. Under tensor parallelism or ZeRO-1
(parallel/sharding.py) the files still hold whole leaves: the model
shards are gathered over the model group, and the optimizer's moment
slices over the data group (the JAX package's `fetch_opt_state`), by
every rank before rank 0 writes; loading cuts each whole leaf to the
rank's shard. So a file written under any layout (n_data, n_model,
zero1) loads under any other.
"""

from __future__ import annotations

import glob
import os
import re
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from ..models.classifier import ClassifierConfig
from ..models.clip.convert import flatten_tree, port_leaves, to_jax_flat
from ..models.clip.convert_method import load_method_checkpoint
from ..models.partition import trainable_mask
from ..parallel.distributed import barrier, process_index
from ..parallel.sharding import (MODEL_AXIS, full_tensors, model_placements,
                                 piece, port_layout)


def save_checkpoint(path: str, flat: Dict[str, np.ndarray], *,
                    extra: Optional[dict] = None) -> None:
    """Save {JAX tree path: array} as an npz; `extra` under '__extra__/'."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    flat = dict(flat)
    for k, v in (extra or {}).items():
        flat[f"__extra__/{k}"] = np.asarray(v)
    tmp = path + ".tmp.npz"
    np.savez(tmp, **flat)
    os.replace(tmp, path)


@torch.no_grad()
def load_checkpoint(path: str, target: Optional[nn.Module] = None):
    """Load an npz checkpoint, or a reference-trained `.pth` / `.pt`
    method checkpoint (converted on the fly), -> (flat {path: array},
    extra).

    With `target` (a ClassifierParams), every saved leaf is copied into the
    matching parameters in place and (target, extra) is returned; leaves
    the checkpoint lacks keep their values (that is how the frozen CLIP
    weights stay). A saved leaf that matches no parameter raises: loading
    would otherwise evaluate an untrained model while claiming it loaded.
    """
    if path.endswith((".pth", ".pt")):
        flat, extra = flatten_tree(load_method_checkpoint(path)), {}
    else:
        with np.load(path, allow_pickle=False) as z:
            flat = {k: z[k] for k in z.files
                    if not k.startswith("__extra__/")}
            extra = {k[len("__extra__/"):]: z[k] for k in z.files
                     if k.startswith("__extra__/")}
    if target is None:
        return flat, extra
    named = dict(target.named_parameters())
    unconsumed = []
    for key, value in flat.items():
        leaves = list(port_leaves(key, value))
        if not all(name in named for name, _ in leaves):
            unconsumed.append(key)
            continue
        for name, leaf in leaves:
            assign_leaf(target, name, named[name], leaf, key)
    if unconsumed:
        raise ValueError(
            f"{len(unconsumed)} checkpoint leaves match no parameter in this "
            f"model (checkpoint/config mismatch?): {sorted(unconsumed)[:6]}")
    return target, extra


@torch.no_grad()
def assign_leaf(target: nn.Module, name: str, p: torch.Tensor, leaf,
                key: str = "") -> None:
    """Copy a whole port-shaped leaf into parameter `p` of `target`, cut
    to this rank's model shard when `target` was sharded."""
    t = torch.from_numpy(np.asarray(leaf))
    tp = getattr(target, "tp", None)
    if tp is not None:
        pl = model_placements(target)[name]
        if pl.axis_dim(MODEL_AXIS) is not None:
            assert np.prod(t.shape) == np.prod(p.shape) * tp.n_model, (
                f"{key or name}: ckpt {tuple(t.shape)} vs a shard "
                f"{tuple(p.shape)} of {tp.n_model}")
            t = port_layout(piece(t, pl, MODEL_AXIS, tp.model_index,
                                  tp.n_model), pl)
    assert tuple(t.shape) == tuple(p.shape), (
        f"{key or name}: ckpt {tuple(t.shape)} vs target {tuple(p.shape)}")
    p.copy_(t.to(p.dtype))


def trainable_flat(cfg: ClassifierConfig, params: nn.Module
                   ) -> Dict[str, np.ndarray]:
    """The trainable leaves as {JAX tree path: array in the JAX shape};
    model shards are gathered to whole leaves first (a collective for the
    model group: every rank of it calls this)."""
    mask = trainable_mask(cfg, params)
    named = [(n, p) for n, p in params.named_parameters() if mask[n]]
    return to_jax_flat(full_tensors(named, model_placements(params),
                                    getattr(params, "tp", None)))


def save_trainable(path: str, cfg: ClassifierConfig, params: nn.Module,
                   *, extra: Optional[dict] = None) -> None:
    """Save only the trainable leaves (the reference's CLIP-free state dict)."""
    save_checkpoint(path, trainable_flat(cfg, params), extra=extra)


class CheckpointManager:
    """Rolling + best checkpoint management under `<ckpt_dir>/models/`:
    `best.npz` for the monitored metric's max, `model_<step>.npz` rolling
    (the reference's discovery logic, test.py:156-167). Only rank 0 of a
    data-parallel run writes (`is_main`); the others only join the
    gathers of a sharded model."""

    def __init__(self, ckpt_dir: str, cfg: ClassifierConfig,
                 monitor: str = "probs_acc", keep_last: int = 3):
        self.dir = os.path.join(ckpt_dir, "models")
        self.is_main = process_index() == 0
        if self.is_main:
            os.makedirs(self.dir, exist_ok=True)
        self.cfg = cfg
        self.monitor = monitor
        self.keep_last = keep_last
        self.best_metric = -np.inf

    def save(self, params: nn.Module, step: int,
             metrics: Optional[Dict[str, float]] = None) -> None:
        sharded = getattr(params, "tp", None) is not None
        if not (self.is_main or sharded):
            return
        flat = trainable_flat(self.cfg, params)
        if not self.is_main:
            return
        save_checkpoint(os.path.join(self.dir, f"model_{step}.npz"), flat,
                        extra={"step": step})
        self._prune()
        if metrics and self.monitor in metrics:
            val = float(metrics[self.monitor])
            if val > self.best_metric:
                self.best_metric = val
                save_checkpoint(os.path.join(self.dir, "best.npz"), flat,
                                extra={"step": step, self.monitor: val})

    def save_resume_state(self, params: nn.Module, optimizer,
                          epoch: int) -> None:
        """Trainable leaves + optimizer state (the frozen CLIP weights are
        re-derivable from the CLIP checkpoint at startup); every rank
        calls it, every rank joins the gathers of model shards and moment
        slices, rank 0 writes, and all leave after the write."""
        gathers = (getattr(params, "tp", None) is not None
                   or getattr(optimizer, "zero1", False))
        if not (self.is_main or gathers):
            barrier()
            return
        flat = trainable_flat(self.cfg, params)
        opt_state = optimizer.state_dict()
        if not self.is_main:
            barrier()
            return
        blob = {
            "epoch": epoch,
            "params": flat,
            "optimizer": opt_state,
            "best_metric": self.best_metric,
        }
        tmp = os.path.join(self.dir, "resume.pt.tmp")
        torch.save(blob, tmp)
        os.replace(tmp, os.path.join(self.dir, "resume.pt"))
        barrier()

    @torch.no_grad()
    def load_resume_state(self, params: nn.Module, optimizer
                          ) -> Optional[int]:
        """Restore parameters and optimizer from resume.pt in place;
        returns the epoch to resume at, or None without a resume file.
        Every rank calls it and reads the same file."""
        barrier()
        path = os.path.join(self.dir, "resume.pt")
        if not os.path.exists(path):
            return None
        blob = torch.load(path, map_location="cpu", weights_only=False)
        named = dict(params.named_parameters())
        for key, value in blob["params"].items():
            for name, leaf in port_leaves(key, value):
                assign_leaf(params, name, named[name], leaf, key)
        optimizer.load_state_dict(blob["optimizer"])
        self.best_metric = float(blob.get("best_metric", -np.inf))
        return int(blob["epoch"])

    def _prune(self) -> None:
        paths = glob.glob(os.path.join(self.dir, "model_*.npz"))

        def step_of(p):
            m = re.search(r"model_(\d+)\.npz$", p)
            return int(m.group(1)) if m else -1

        for p in sorted(paths, key=step_of)[: -self.keep_last]:
            os.remove(p)

    def latest(self) -> Optional[str]:
        """best.npz if present else the newest rolling ckpt (test.py:156-167)."""
        best = os.path.join(self.dir, "best.npz")
        if os.path.exists(best):
            return best
        paths = glob.glob(os.path.join(self.dir, "model_*.npz"))
        if not paths:
            return None
        return max(paths, key=lambda p: int(re.search(r"model_(\d+)", p).group(1)))
