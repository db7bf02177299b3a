"""Trainable-parameter partitioning.

Port of eventclip_tpu/models/partition.py. The reference controls training
granularity with requires_grad surgery (models/clip_cls.py:38-44 freeze-all;
models/clip_cls_ft.py:45-81 selective unfreeze; LoRA injection). The JAX
package turns that policy into a boolean mask over its parameter tree; here
the same policy decides on each parameter's JAX tree path
(models/clip/convert.py::jax_path), so both packages train, and save, the
same leaves, and `set_trainable` applies it as `requires_grad`.
"""

from __future__ import annotations

from typing import Dict

from torch import nn

from .classifier import ClassifierConfig
from .clip.convert import jax_path


def _visual_leaf_trainable(path: str, ft_mode: str) -> bool:
    if ft_mode == "full":
        return True
    if ft_mode == "lora":
        return False  # lora deltas live in their own subtree
    if ft_mode == "conv1":
        return path.endswith("patch_embed")
    if ft_mode == "bias":
        # every torch parameter with 'bias' in its name (clip_cls_ft.py:63-66):
        # LN biases, attention in/out-proj biases, MLP biases
        return path.endswith("bias") or path.split("/")[-1] in (
            "bqkv", "bo", "b1", "b2")
    if ft_mode == "ln":
        return any(seg.startswith("ln_") for seg in path.split("/"))
    if ft_mode == "cls_fc":
        return path.endswith("proj") and not path.endswith("patch_embed")
    if ft_mode == "cls_token":
        return path.endswith("class_embedding")
    raise NotImplementedError(ft_mode)


def path_trainable(cfg: ClassifierConfig, path: str) -> bool:
    """Whether the leaf at JAX tree path `path` receives gradient updates."""
    if path.startswith("text_feats"):
        return cfg.prompt_tuning
    if path.startswith("adapter"):
        return cfg.model == "FSCLIP"
    if path.startswith("lora"):
        return True
    if path.startswith("clip/visual"):
        return cfg.model == "FTCLIP" and _visual_leaf_trainable(
            path, cfg.ft_mode)
    return False  # text tower, logit_scale: always frozen


def trainable_mask(cfg: ClassifierConfig, params: nn.Module
                   ) -> Dict[str, bool]:
    """{port parameter name: trainable}."""
    return {name: path_trainable(cfg, jax_path(name)[0])
            for name, _ in params.named_parameters()}


def set_trainable(cfg: ClassifierConfig, params: nn.Module
                  ) -> Dict[str, bool]:
    """Set `requires_grad` from `trainable_mask`; returns the mask."""
    mask = trainable_mask(cfg, params)
    for name, p in params.named_parameters():
        p.requires_grad_(mask[name])
    return mask
