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
            p = named[name]
            assert tuple(leaf.shape) == tuple(p.shape), (
                f"{key}: ckpt {leaf.shape} vs target {tuple(p.shape)}")
            p.copy_(torch.from_numpy(np.asarray(leaf)).to(p.dtype))
    if unconsumed:
        raise ValueError(
            f"{len(unconsumed)} checkpoint leaves match no parameter in this "
            f"model (checkpoint/config mismatch?): {sorted(unconsumed)[:6]}")
    return target, extra


def trainable_flat(cfg: ClassifierConfig, params: nn.Module
                   ) -> Dict[str, np.ndarray]:
    """The trainable leaves as {JAX tree path: array in the JAX shape}."""
    mask = trainable_mask(cfg, params)
    return to_jax_flat((n, p) for n, p in params.named_parameters()
                       if mask[n])


def save_trainable(path: str, cfg: ClassifierConfig, params: nn.Module,
                   *, extra: Optional[dict] = None) -> None:
    """Save only the trainable leaves (the reference's CLIP-free state dict)."""
    save_checkpoint(path, trainable_flat(cfg, params), extra=extra)


class CheckpointManager:
    """Rolling + best checkpoint management under `<ckpt_dir>/models/`:
    `best.npz` for the monitored metric's max, `model_<step>.npz` rolling
    (the reference's discovery logic, test.py:156-167)."""

    def __init__(self, ckpt_dir: str, cfg: ClassifierConfig,
                 monitor: str = "probs_acc", keep_last: int = 3):
        self.dir = os.path.join(ckpt_dir, "models")
        os.makedirs(self.dir, exist_ok=True)
        self.cfg = cfg
        self.monitor = monitor
        self.keep_last = keep_last
        self.best_metric = -np.inf

    def save(self, params: nn.Module, step: int,
             metrics: Optional[Dict[str, float]] = None) -> None:
        flat = trainable_flat(self.cfg, params)
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
        re-derivable from the CLIP checkpoint at startup)."""
        blob = {
            "epoch": epoch,
            "params": trainable_flat(self.cfg, params),
            "optimizer": optimizer.state_dict(),
            "best_metric": self.best_metric,
        }
        tmp = os.path.join(self.dir, "resume.pt.tmp")
        torch.save(blob, tmp)
        os.replace(tmp, os.path.join(self.dir, "resume.pt"))

    @torch.no_grad()
    def load_resume_state(self, params: nn.Module, optimizer
                          ) -> Optional[int]:
        """Restore parameters and optimizer from resume.pt in place;
        returns the epoch to resume at, or None without a resume file."""
        path = os.path.join(self.dir, "resume.pt")
        if not os.path.exists(path):
            return None
        blob = torch.load(path, map_location="cpu", weights_only=False)
        named = dict(params.named_parameters())
        for key, value in blob["params"].items():
            for name, leaf in port_leaves(key, value):
                named[name].copy_(torch.from_numpy(np.asarray(leaf)))
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
