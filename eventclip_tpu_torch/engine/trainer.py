"""Parameter resolution and text features shared by the entry points.

Port of `resolve_clip_params` (the smoke/debug random-init branch),
`snapshot_logit_scale` and `build_text_features` from
eventclip_tpu/engine/trainer.py. Loading released CLIP weights and the BPE
tokenizer come in later slices; until then text features computed
elsewhere (models.classifier.compute_text_features on prompt token ids)
are passed in, and otherwise random ones stand in (smoke/debug runs only,
as in the JAX package without the vocab).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch

from ..models.classifier import normalize
from ..models.clip.model import CLIP, init_clip_params


def resolve_clip_params(params_cfg, clip_cfg, generator: torch.Generator,
                        smoke: bool = False, device="cuda"):
    """(CLIP towers, pretrained) — random init in smoke/debug mode.

    Running without a checkpoint is an error unless `smoke` is set or the
    arch is a debug tower (no released weights), because random towers
    give garbage accuracies without otherwise failing."""
    if params_cfg.get("clip_ckpt", None):
        raise NotImplementedError(
            "loading released CLIP weights is not ported yet; pass the "
            "towers as clip_params= or run with smoke=True")
    if not (smoke or clip_cfg.debug):
        raise FileNotFoundError(
            f"No CLIP checkpoint for {clip_cfg.name!r}; pass smoke=True to "
            "run with RANDOM weights (throughput/pipeline testing only)")
    print("WARNING: smoke mode - RANDOM CLIP weights; accuracies are garbage")
    return init_clip_params(clip_cfg, generator, device=device), False


def snapshot_logit_scale(cls_cfg, clip: CLIP, pretrained: bool):
    """Snapshot exp(learned tau) from the checkpoint into the classifier
    config (reference models/clip_cls.py:44); random-init runs keep the
    config default of 100.0."""
    if not pretrained:
        return cls_cfg
    return dataclasses.replace(
        cls_cfg, logit_scale=math.exp(float(clip.logit_scale)))


def build_text_features(clip: CLIP, clip_cfg, class_names: Sequence[str],
                        pretrained: bool) -> torch.Tensor:
    """L2-normalized class text features [n_cls, C] for a Predictor given
    none: with no tokenizer in the port yet, random features drawn from a
    seeded generator stand in — refused for pretrained towers, where they
    would silently produce garbage zero-shot numbers."""
    if pretrained:
        raise FileNotFoundError(
            "no tokenizer yet: pass text_feats= (compute_text_features on "
            "prompt token ids) to classify with real CLIP weights")
    print("WARNING: no tokenizer - random text features (smoke mode)")
    gen = torch.Generator(device="cpu").manual_seed(1234)
    feats = torch.randn((len(class_names), clip_cfg.embed_dim), generator=gen)
    return normalize(feats).to(clip.logit_scale.device)
