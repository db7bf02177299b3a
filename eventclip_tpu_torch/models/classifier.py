"""EventCLIP zero-shot classifier head.

Port of the ZS half of eventclip_tpu/models/classifier.py (behavioral
contract: reference models/clip_cls.py:95-162). Image features are used raw
(the reference never normalizes them in ZS) against cached L2-normalized
text features; per-view logits are aggregated over the valid views.

FSCLIP (adapter) and FTCLIP (fine-tuned tower) come in later slices.
`params` is a dict {'clip': CLIP module, 'text_feats': f32 [n_cls, C]}.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from .clip.config import CLIPConfig
from .clip.model import encode_image, encode_text

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class ClassifierConfig:
    model: str  # 'ZSCLIP' (FSCLIP / FTCLIP come later)
    clip: CLIPConfig
    agg_func: str = "mean"  # 'sum' | 'mean' | 'max'
    logit_scale: float = 100.0  # exp(learned tau), snapshot like the reference
    dtype: torch.dtype = torch.float32  # visual tower activations

    def __post_init__(self):
        if self.model != "ZSCLIP":
            raise NotImplementedError(
                f"{self.model}: only the zero-shot head is ported so far")
        assert self.agg_func in ("sum", "mean", "max"), self.agg_func


def build_classifier_config(params_cfg, clip_cfg: CLIPConfig,
                            dtype=torch.float32) -> ClassifierConfig:
    """Build from an experiment config object (utils.config.Params)."""
    if params_cfg.model != "ZSCLIP":
        raise NotImplementedError(
            f"{params_cfg.model}: the FS/FT heads are not ported yet")
    clip_dict = dict(params_cfg.clip_dict)
    return ClassifierConfig(
        model=params_cfg.model,
        clip=clip_cfg,
        # config override is for debug/random towers; real checkpoints
        # override it at load (engine.trainer.snapshot_logit_scale)
        logit_scale=float(clip_dict.get("logit_scale", 100.0)),
        agg_func=clip_dict.get("agg_func", "mean"),
        dtype=dtype,
    )


def normalize(x: torch.Tensor, dim: int = -1,
              eps: float = 1e-12) -> torch.Tensor:
    """L2 normalize; zero vectors stay zero (torch F.normalize semantics)."""
    n = torch.linalg.vector_norm(x, dim=dim, keepdim=True)
    return x / torch.clamp(n, min=eps)


@torch.no_grad()
def compute_text_features(clip, tokens: torch.Tensor) -> torch.Tensor:
    """Prompt token ids [n_cls, context] -> L2-normalized features
    [n_cls, C] (the text tower runs in f32, as the JAX package's)."""
    return normalize(encode_text(clip.text, tokens))


def aggregate_logits(logits: torch.Tensor, valid: torch.Tensor,
                     agg_func: str) -> torch.Tensor:
    """[B, T, n_cls] + [B, T] -> [B, n_cls] (clip_cls.py:104-121)."""
    vm = valid.to(logits.dtype)
    if agg_func == "sum":
        return (logits * vm[..., None]).sum(1)
    if agg_func == "mean":
        return (logits * vm[..., None]).sum(1) / vm.sum(1, keepdim=True)
    if agg_func == "max":
        return (logits - (1.0 - vm[..., None]) * 1e6).amax(1)
    raise NotImplementedError(agg_func)


def aggregate_probs(logits: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Masked mean of per-view softmax (clip_cls.py:123-129). Rows with no
    valid view come out NaN (0/0), as in the JAX package."""
    vm = valid.to(logits.dtype)
    probs = torch.softmax(logits, dim=-1) * vm[..., None]
    return probs.sum(1) / vm.sum(1, keepdim=True)


def _encode_views(params: Params, cfg: ClassifierConfig,
                  flat_imgs: torch.Tensor) -> torch.Tensor:
    """[V, 3, S, S] -> [V, C] raw (un-normalized) f32 encoder features."""
    return encode_image(params["clip"].visual, flat_imgs,
                        dtype=cfg.dtype).float()


def classifier_forward(params: Params, cfg: ClassifierConfig,
                       imgs: torch.Tensor,
                       valid: torch.Tensor) -> Dict[str, torch.Tensor]:
    """imgs [B, T, 3, S, S] CLIP-normalized, valid [B, T] -> output dict.

    All T views are encoded (padded views carry zeros) and masked after."""
    B, T = valid.shape
    flat = imgs.reshape((B * T,) + tuple(imgs.shape[2:]))
    feats = _encode_views(params, cfg, flat).reshape(B, T, -1)
    return _aggregate_head(params, cfg, feats, valid)


def classifier_forward_packed(params: Params, cfg: ClassifierConfig,
                              imgs: torch.Tensor, view_src: torch.Tensor,
                              valid: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Forward over view-PACKED images (only valid views encoded).

    imgs [K, 3, S, S] holds the batch's valid views compacted across
    samples; view_src [K] maps each row to its flat slot in [B*T] (the
    sentinel B*T marks packing padding, summed into a spare slot that is
    dropped)."""
    B, T = valid.shape
    feats_k = _encode_views(params, cfg, imgs)
    C = feats_k.shape[-1]
    flat = torch.zeros((B * T + 1, C), dtype=torch.float32,
                       device=feats_k.device)
    flat.index_add_(0, view_src.to(torch.int64), feats_k)
    feats = flat[: B * T].reshape(B, T, C)
    return _aggregate_head(params, cfg, feats, valid)


def _aggregate_head(params: Params, cfg: ClassifierConfig,
                    feats: torch.Tensor,
                    valid: torch.Tensor) -> Dict[str, torch.Tensor]:
    """ZS post-encoder half: raw features (clip_cls.py:148) against the
    text features, masked, aggregated."""
    text_feats = params["text_feats"]
    full_logits = cfg.logit_scale * torch.einsum(
        "btc,nc->btn", feats.float(), text_feats.float())
    full_logits = full_logits * valid[..., None]
    return {
        "full_logits": full_logits,
        "valid_masks": valid,
        "logits": aggregate_logits(full_logits, valid, cfg.agg_func),
        "probs": aggregate_probs(full_logits, valid),
        "view_feats": feats,
    }
