"""Optimizer construction.

Port of eventclip_tpu/engine/optim.py. Behavioral contract (reference
method.py:82-98, 150-193):
- Adam or AdamW, weight_decay asserted 0 for Adam;
- parameter groups by the JAX package's labels: 'base' (text features,
  adapter) at `lr`; for FTCLIP, 'visual' (`clip/visual/*` and `lora/*`)
  at `clip_lr`; each with its own warmup-cosine schedule, read at optax's
  count, so the first update uses lr(0) = min_lr;
- frozen parameters are not in the optimizer: no update and no state.

`grad_clip > 0` clips by the global norm as optax.clip_by_global_norm does
ahead of the JAX package's multi_transform — over ALL gradients jax.grad
produces, which includes those of frozen visual leaves (in, e.g., `ln` or
`lora` mode the tower's frozen weights get a gradient there). So with
clipping on, those leaves take part in the backward and the norm, and are
never updated. The shipped FT configs leave clipping off. Under tensor
parallelism the norm is still that of the logical leaves: the squares of
the model-sharded leaves are summed over the model group, and each
replicated leaf counts once.

ZeRO-1 (`zero1=True` over more than one data rank): each data rank keeps
the Adam / AdamW moments only for its slice of each trained leaf (the
JAX package's `zero1_pspecs`: the data axis on the largest still-unsharded
dim that divides by n_data, parallel/sharding.py), updates that slice from
the already all-reduced (and clipped) gradient, and all-gathers the
updated slices over the data group, so every rank holds the same
parameters. torch's optimizer is given views of the slices in the leaves'
own storage, so the update writes the leaf in place and no copy of the
slices is kept. The update is elementwise, so a slice's update is the
whole leaf's update on those elements. `state_dict` is always the one-process
format of whole leaves (gathered over the data and model groups: a
collective for every rank), and `load_state_dict` cuts it to this rank's
layout, so a resume file crosses layouts.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import torch
from torch import nn

from ..models.classifier import ClassifierConfig
from ..models.clip.convert import jax_path
from ..models.partition import set_trainable, trainable_mask
from ..parallel import distributed as D
from ..parallel.sharding import (DATA_AXIS, MODEL_AXIS, full_tensors,
                                 gather_pieces, model_placements, piece,
                                 shard_opt_state, zero1_placement)
from .schedule import warmup_cosine

_MOMENTS = ("exp_avg", "exp_avg_sq")


@dataclasses.dataclass(frozen=True)
class OptimConfig:
    optimizer: str = "adam"  # 'adam' | 'adamw'
    lr: float = 1e-3
    clip_lr: float = 1e-4  # FTCLIP visual-tower group
    weight_decay: float = 0.0
    total_steps: int = 1000
    warmup_steps_pct: float = 0.05
    grad_clip: float = 0.0  # reference: nerv clip_grad = -1 (off) by default


def optimizer_labels(cls_cfg: ClassifierConfig, params: nn.Module
                     ) -> Dict[str, str]:
    """{port parameter name: 'frozen' | 'base' | 'visual'} (the clip_lr
    group)."""
    mask = trainable_mask(cls_cfg, params)

    def label(name):
        if not mask[name]:
            return "frozen"
        # reference groups by 'model.visual' in the torch param name
        # (method.py:166-172); LoRA deltas live inside the visual tower too
        path = jax_path(name)[0]
        if path.startswith(("clip/visual", "lora")):
            return "visual"
        return "base"

    return {name: label(name) for name in mask}


class Optimizer:
    """torch Adam / AdamW over the trainable parameters, one group per
    label, each group's lr set from its schedule before every update.
    Building it sets `requires_grad` from the trainable mask. The
    parameters may be model shards (parallel/sharding.py's `shard_params`
    ran first); `zero1` keeps the moments of this data rank's slices only
    (see the module docstring)."""

    def __init__(self, cls_cfg: ClassifierConfig, opt_cfg: OptimConfig,
                 params: nn.Module, zero1: bool = False):
        name = opt_cfg.optimizer.lower()
        if name == "adam":
            if opt_cfg.weight_decay != 0.0:
                raise ValueError("Adam takes no weight decay; use AdamW")
            make, kw = torch.optim.Adam, {}
        elif name == "adamw":
            make, kw = torch.optim.AdamW, {"weight_decay": opt_cfg.weight_decay}
        else:
            raise ValueError(
                f"Should use Adam or AdamW optimizer! (got {opt_cfg.optimizer})")
        set_trainable(cls_cfg, params)
        labels = optimizer_labels(cls_cfg, params)
        named = dict(params.named_parameters())
        visual_lr = opt_cfg.clip_lr if cls_cfg.model == "FTCLIP" else opt_cfg.lr
        self.tp = getattr(params, "tp", None)
        self.placements = model_placements(params)
        self.data_index, self.n_data = D.host_shard_info(self.tp)
        self._data_group = D.data_group(self.tp)
        self.zero1 = bool(zero1) and self.n_data > 1
        self.schedules = {}
        groups = []
        self.names: List[str] = []
        # ZeRO-1: the optimizer updates a view of this rank's slice of
        # each trained leaf; the slices' placements carry the data axis
        self._slices: List[torch.Tensor] = []
        self._zpls = []
        for group, max_lr in (("base", opt_cfg.lr), ("visual", visual_lr)):
            names = [n for n, lab in labels.items() if lab == group]
            if names:
                self.names += names
                ps = [named[n] for n in names]
                if self.zero1:
                    zpls = [zero1_placement(self.placements[n], self.n_data)
                            for n in names]
                    self._zpls += zpls
                    ps = [self._slice(p.data, zp) for p, zp in zip(ps, zpls)]
                    self._slices += ps
                self.schedules[group] = warmup_cosine(
                    max_lr, opt_cfg.total_steps, opt_cfg.warmup_steps_pct)
                groups.append({"params": ps, "name": group,
                               "lr": self.schedules[group](0)})
        # optax's defaults (b1 0.9, b2 0.999, eps 1e-8; AdamW's decay is
        # decoupled and scaled by the lr, as optax.adamw's)
        self.torch_opt = make(groups, betas=(0.9, 0.999), eps=1e-8, **kw)
        self.grad_clip = float(opt_cfg.grad_clip or 0.0)
        self.trained: List[torch.Tensor] = [named[n] for n in self.names]
        # frozen leaves whose gradients optax's global norm also sums (see
        # the module docstring): computed, clipped against, never applied
        frozen_names: List[str] = []
        if self.grad_clip > 0 and cls_cfg.model == "FTCLIP":
            frozen_names = [
                n for n, lab in labels.items()
                if lab == "frozen" and jax_path(n)[0].startswith("clip/visual")]
        self.frozen_in_norm = [named[n].requires_grad_(True)
                               for n in frozen_names]
        self.norm_params = self.trained + self.frozen_in_norm
        self._norm_split = [
            self.placements[n].axis_dim(MODEL_AXIS) is not None
            for n in self.names + frozen_names]
        self.count = 0  # updates applied (optax's count)

    def _slice(self, t: torch.Tensor, zpl) -> torch.Tensor:
        """This data rank's ZeRO-1 slice of a (local) leaf, as a view."""
        return piece(t, zpl, DATA_AXIS, self.data_index, self.n_data)

    def _global_norm(self) -> torch.Tensor:
        """optax's global norm over the logical leaves: under tensor
        parallelism the model shards' squares summed over the model
        group, each replicated leaf once."""
        grads = [(p.grad, split) for p, split in
                 zip(self.norm_params, self._norm_split)
                 if p.grad is not None]
        if self.tp is None:
            return torch.linalg.vector_norm(torch.stack(
                [torch.linalg.vector_norm(g.float()) for g, _ in grads]))
        dev = grads[0][0].device
        sq = torch.zeros(2, dtype=torch.float32, device=dev)
        for g, split in grads:
            sq[int(split)] += torch.linalg.vector_norm(g.float()) ** 2
        D.model_all_reduce_sum_(sq[1:], self.tp)
        return sq.sum().sqrt()

    def moment_bytes(self) -> int:
        """Bytes of Adam moments this rank holds."""
        return sum(st[k].numel() * st[k].element_size()
                   for st in self.torch_opt.state.values()
                   for k in _MOMENTS if k in st)

    def zero_grad(self) -> None:
        for p in self.norm_params:
            p.grad = None

    @torch.no_grad()
    def step(self) -> None:
        """One update from the gradients in .grad (clipped first when
        grad_clip > 0); then the frozen leaves' gradients are dropped."""
        if self.grad_clip > 0:
            norm = self._global_norm()
            # optax: where(norm < max, g, g / norm * max)
            factor = torch.where(norm < self.grad_clip, 1.0,
                                 self.grad_clip / norm)
            for p in self.norm_params:
                if p.grad is not None:
                    p.grad.mul_(factor)
        for group in self.torch_opt.param_groups:
            group["lr"] = self.schedules[group["name"]](self.count)
        if self.zero1:
            # each slice views its leaf's storage as it is now (set again
            # every step: the parameter objects, Adam's state keys, stay)
            # and takes its gradient's slice
            for p, s, zp in zip(self.trained, self._slices, self._zpls):
                s.data = self._slice(p.data, zp)
                s.grad = (None if p.grad is None else
                          self._slice(p.grad, zp))
            self.torch_opt.step()
            # the gradient views would keep the whole gradients alive
            # past the next zero_grad
            for s in self._slices:
                s.grad = None
            gather_pieces([p.data for p in self.trained], self._zpls,
                          self._slices, DATA_AXIS, self.data_index,
                          self.n_data, self._data_group)
        else:
            self.torch_opt.step()
        self.count += 1
        for p in self.frozen_in_norm:
            p.grad = None

    def state_dict(self) -> dict:
        """{'count', 'torch_opt'}: the one-process state of whole leaves
        whatever the layout (a collective under tensor parallelism or
        ZeRO-1: every rank calls it)."""
        sd = self.torch_opt.state_dict()
        if self.zero1 or self.tp is not None:
            sd = dict(sd, state=self._whole_state(sd["state"]))
        return {"count": self.count, "torch_opt": sd}

    def _whole_state(self, state: dict) -> dict:
        """Moments gathered to whole leaves: ZeRO-1 slices over the data
        group, then model shards over the model group."""
        idx = sorted(state)
        out = {i: dict(state[i]) for i in idx}
        for key in _MOMENTS:
            local = {i: state[i][key] for i in idx}
            if self.zero1:
                targets = {i: torch.zeros_like(self.trained[i]) for i in idx}
                gather_pieces([targets[i] for i in idx],
                              [self._zpls[i] for i in idx],
                              [local[i] for i in idx], DATA_AXIS,
                              self.data_index, self.n_data, self._data_group)
                local = targets
            whole = dict(full_tensors([(self.names[i], local[i]) for i in idx],
                                      self.placements, self.tp))
            for i in idx:
                out[i][key] = whole[self.names[i]]
        return out

    def load_state_dict(self, state: dict) -> None:
        """Restore from `state_dict`'s format (whole leaves, written under
        any layout), cut to this rank's shards and slices."""
        self.count = int(state["count"])
        sd = state["torch_opt"]
        if self.zero1 or self.tp is not None:
            local = {}
            for i, st in sd["state"].items():
                name = self.names[int(i)]
                cut = {k: shard_opt_state(
                    {name: st[k]}, self.placements, self.tp, self.n_data,
                    self.data_index, self.zero1)[name] for k in _MOMENTS
                    if k in st}
                local[i] = dict(st, **cut)
            sd = dict(sd, state=local)
        self.torch_opt.load_state_dict(sd)
