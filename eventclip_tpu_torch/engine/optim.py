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
never updated. The shipped FT configs leave clipping off.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import torch
from torch import nn

from ..models.classifier import ClassifierConfig
from ..models.clip.convert import jax_path
from ..models.partition import set_trainable, trainable_mask
from .schedule import warmup_cosine


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
    Building it sets `requires_grad` from the trainable mask."""

    def __init__(self, cls_cfg: ClassifierConfig, opt_cfg: OptimConfig,
                 params: nn.Module):
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
        self.schedules = {}
        groups = []
        for group, max_lr in (("base", opt_cfg.lr), ("visual", visual_lr)):
            ps = [named[n] for n, lab in labels.items() if lab == group]
            if ps:
                self.schedules[group] = warmup_cosine(
                    max_lr, opt_cfg.total_steps, opt_cfg.warmup_steps_pct)
                groups.append({"params": ps, "name": group,
                               "lr": self.schedules[group](0)})
        # optax's defaults (b1 0.9, b2 0.999, eps 1e-8; AdamW's decay is
        # decoupled and scaled by the lr, as optax.adamw's)
        self.torch_opt = make(groups, betas=(0.9, 0.999), eps=1e-8, **kw)
        self.grad_clip = float(opt_cfg.grad_clip or 0.0)
        self.trained: List[torch.Tensor] = [p for g in groups
                                            for p in g["params"]]
        # frozen leaves whose gradients optax's global norm also sums (see
        # the module docstring): computed, clipped against, never applied
        self.frozen_in_norm: List[torch.Tensor] = []
        if self.grad_clip > 0 and cls_cfg.model == "FTCLIP":
            self.frozen_in_norm = [
                named[n].requires_grad_(True) for n, lab in labels.items()
                if lab == "frozen" and jax_path(n)[0].startswith("clip/visual")]
        self.norm_params = self.trained + self.frozen_in_norm
        self.count = 0  # updates applied (optax's count)

    def zero_grad(self) -> None:
        for p in self.norm_params:
            p.grad = None

    @torch.no_grad()
    def step(self) -> None:
        """One update from the gradients in .grad (clipped first when
        grad_clip > 0); then the frozen leaves' gradients are dropped."""
        if self.grad_clip > 0:
            grads = [p.grad for p in self.norm_params if p.grad is not None]
            norm = torch.linalg.vector_norm(torch.stack(
                [torch.linalg.vector_norm(g.float()) for g in grads]))
            # optax: where(norm < max, g, g / norm * max)
            factor = torch.where(norm < self.grad_clip, 1.0,
                                 self.grad_clip / norm)
            for g in grads:
                g.mul_(factor)
        for group in self.torch_opt.param_groups:
            group["lr"] = self.schedules[group["name"]](self.count)
        self.torch_opt.step()
        self.count += 1
        for p in self.frozen_in_norm:
            p.grad = None

    def state_dict(self) -> dict:
        return {"count": self.count, "torch_opt": self.torch_opt.state_dict()}

    def load_state_dict(self, state: dict) -> None:
        self.count = int(state["count"])
        self.torch_opt.load_state_dict(state["torch_opt"])
