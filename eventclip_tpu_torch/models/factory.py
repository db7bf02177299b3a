"""Model factory: the reference's `build_model(params)` convenience API.

Port of eventclip_tpu/models/factory.py (reference models/__init__.py:5-21):
a config object in, a ready classifier out. `EventCLIPModel` bundles the
classifier config and its parameters behind the reference's calling
convention, `model(data_dict)` returning {'full_logits', 'valid_masks',
'logits', 'probs', 'view_feats'}.

The port has no tokenizer yet, so `build_model` takes the class text
features; without them it draws random ones, which it refuses for
pretrained towers (random text features would silently give garbage
accuracies).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

from .classifier import (ClassifierConfig, ClassifierParams,
                         build_classifier_config, classifier_forward,
                         init_classifier_params)
from .clip.config import clip_arch_config
from .clip.convert import clip_from_jax
from .clip.model import CLIP


class EventCLIPModel:
    """Bundled (config, parameters, forward)."""

    def __init__(self, cfg: ClassifierConfig, params: ClassifierParams):
        self.cfg = cfg
        self.params = params

    @torch.inference_mode()
    def __call__(self, data_dict: Dict[str, torch.Tensor]
                 ) -> Dict[str, torch.Tensor]:
        return classifier_forward(self.params, self.cfg, data_dict["img"],
                                  data_dict["valid_mask"])

    def load_weight(self, path: str) -> None:
        """Load the trainable leaves of a CLIP-free checkpoint (either
        package's npz) into the parameters (reference BaseModel.load_weight
        plus its state-dict surgery)."""
        from ..engine.checkpoint import load_checkpoint

        load_checkpoint(path, target=self.params)


def build_model(params_cfg, class_names: Sequence[str], clip_params=None,
                text_feats: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                dtype: torch.dtype = torch.bfloat16,
                device="cuda") -> EventCLIPModel:
    """Build a ZS/FS/FT classifier from an experiment config on `device`.

    clip_params: pretrained towers (a port `CLIP`, used as given, or the
        JAX package's parameter tree as numpy arrays); random towers drawn
        from `generator` when omitted (smoke mode).
    text_feats: [n_cls, C] prompt features (models.classifier.
        compute_text_features); required with pretrained towers, drawn at
        random otherwise.
    """
    device = torch.device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    clip_cfg = clip_arch_config(params_cfg.clip_dict["arch"])
    cfg = build_classifier_config(params_cfg, clip_cfg, dtype=dtype)
    pretrained = clip_params is not None
    if pretrained and text_feats is None:
        raise FileNotFoundError(
            "no tokenizer yet: pass text_feats= (compute_text_features on "
            "prompt token ids) with pretrained CLIP towers; random text "
            "features would silently give garbage accuracies")
    if pretrained and not isinstance(clip_params, CLIP):
        clip_params = clip_from_jax(clip_params, clip_cfg, device)
    params = init_classifier_params(cfg, generator, clip=clip_params,
                                    text_feats=text_feats,
                                    n_classes=len(class_names), device=device)
    return EventCLIPModel(cfg, params)
