"""Model factory: the reference's `build_model(params)` convenience API.

Port of eventclip_tpu/models/factory.py (reference models/__init__.py:5-21):
a config object in, a ready classifier out. `EventCLIPModel` bundles the
classifier config and its parameters behind the reference's calling
convention, `model(data_dict)` returning {'full_logits', 'valid_masks',
'logits', 'probs', 'view_feats'}.

Without class text features, `build_model` computes them from the
config's prompt through the BPE tokenizer and the text tower; without the
vocab it draws random ones, which it refuses for pretrained towers
(random text features would silently give garbage accuracies).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

from .classifier import (DEFAULT_PROMPT, ClassifierConfig,
                         ClassifierParams, build_classifier_config,
                         class_text_features, classifier_forward,
                         init_classifier_params)
from .clip.config import clip_arch_config
from .clip.convert import clip_from_jax
from .clip.model import CLIP, init_clip_params
from .clip.tokenizer import SimpleTokenizer


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
    text_feats: [n_cls, C] prompt features; computed from the config's
        prompt through the tokenizer and the text tower when omitted, drawn
        at random when the vocab is missing (refused for pretrained
        towers).
    """
    device = torch.device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    clip_cfg = clip_arch_config(params_cfg.clip_dict["arch"])
    cfg = build_classifier_config(params_cfg, clip_cfg, dtype=dtype)
    pretrained = clip_params is not None
    if clip_params is None:
        clip_params = init_clip_params(clip_cfg, generator, device=device)
    elif not isinstance(clip_params, CLIP):
        clip_params = clip_from_jax(clip_params, clip_cfg, device)
    if text_feats is None:
        try:
            tokenizer = SimpleTokenizer()
        except (FileNotFoundError, OSError) as e:
            if pretrained:
                raise FileNotFoundError(
                    "BPE vocab asset missing; drop "
                    "bpe_simple_vocab_16e6.txt.gz into eventclip_tpu_torch/"
                    "assets/ or set EVENTCLIP_BPE_PATH: real CLIP weights "
                    "with random text features would silently give garbage "
                    f"accuracies. ({e})") from e
        else:
            with torch.inference_mode():
                text_feats = class_text_features(
                    clip_params, class_names,
                    params_cfg.clip_dict.get("prompt", DEFAULT_PROMPT),
                    tokenizer)
    params = init_classifier_params(cfg, generator, clip=clip_params,
                                    text_feats=text_feats,
                                    n_classes=len(class_names), device=device)
    return EventCLIPModel(cfg, params)
