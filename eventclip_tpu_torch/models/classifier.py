"""EventCLIP classifier heads: zero-shot (ZS), few-shot (FS), fine-tuned
(FT).

Port of eventclip_tpu/models/classifier.py (behavioral contract: reference
models/clip_cls.py:95-350, models/clip_cls_ft.py:45-256). One forward
serves the three regimes; the regime decides which parameters receive
gradients (models/partition.py) and how image features are treated:

- ZS: raw (un-normalized!) frozen image features against cached
  normalized text features (the reference never normalizes them in ZS);
- FS: frozen image features -> the view adapter (models/adapter.py) ->
  L2 norm -> mask; the adapter trains;
- FT: a (partly) trainable visual tower, adapter bypassed, L2-normalized
  features.

With prompt tuning (`adapter_type='text-...'`) the text features are a
trainable parameter, re-normalized on every forward. The parameters are
one `ClassifierParams` module: the CLIP towers, the text features, and the
FS adapter or the FT LoRA deltas.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np
import torch
from torch import nn
from torch.profiler import record_function

from .adapter import (Adapter, AdapterConfig, apply_adapter,
                      init_adapter_params)
from .clip.config import CLIPConfig, ResNetVisionConfig
from .clip.model import (CLIP, LoRA, encode_image, encode_text,
                         init_clip_params, init_lora_params)
from .clip.resnet import encode_image_resnet
from .clip.tokenizer import SimpleTokenizer, tokenize

# the reference's prompt template (configs override it with
# clip_dict['prompt']); every consumer falls back to this one constant
DEFAULT_PROMPT = "a point cloud image of a {}"


@dataclasses.dataclass(frozen=True)
class ClassifierConfig:
    model: str  # 'ZSCLIP' | 'FSCLIP' | 'FTCLIP'
    clip: CLIPConfig
    agg_func: str = "mean"  # 'sum' | 'mean' | 'max'
    logit_scale: float = 100.0  # exp(learned tau), snapshot like the reference
    adapter: AdapterConfig = AdapterConfig()
    prompt_tuning: bool = False
    lora: Optional[object] = None  # e.g. 16 -> 'qkv-16'; None -> disabled
    ft_mode: str = "full"  # 'full'|'conv1'|'bias'|'ln'|'cls_fc'|'cls_token'|'lora'
    use_logits_loss: bool = True
    use_probs_loss: bool = False
    dtype: torch.dtype = torch.float32  # visual tower activations
    remat: bool = False  # recompute transformer blocks in the backward (FT)
    # eval-time ViT token pruning: keep the K highest-variance patches
    # (sparse event frames are mostly uniform background); None = full
    # sequence. Ignored during training and for ResNet towers.
    keep_tokens: Optional[int] = None

    def __post_init__(self):
        assert self.model in ("ZSCLIP", "FSCLIP", "FTCLIP"), self.model
        assert self.agg_func in ("sum", "mean", "max"), self.agg_func
        assert int(self.use_logits_loss) + int(self.use_probs_loss) == 1
        if self.model == "FTCLIP":
            # the reference asserts adapter==identity and bypasses it in
            # forward (models/clip_cls_ft.py:119,228)
            assert self.adapter.adapter_type == "identity"


def build_classifier_config(params_cfg, clip_cfg: CLIPConfig,
                            dtype=torch.float32) -> ClassifierConfig:
    """Build from an experiment config object (utils.config.Params)."""
    clip_dict = dict(params_cfg.clip_dict)
    adapter_dict = dict(params_cfg.get("adapter_dict", {}) or {})
    adapter_type = adapter_dict.pop("adapter_type", "identity").lower()
    prompt_tuning = adapter_type.startswith("text-")
    if prompt_tuning:
        adapter_type = adapter_type[len("text-"):]
    residual = AdapterConfig.residual_value(adapter_dict.pop("residual", False))
    norm_first = adapter_dict.pop("norm_first", True)
    assert norm_first, "reference adapters are pre-norm"
    # in_dim always tracks the CLIP feature dim, whatever the config says
    # (the reference overrides it the same way, train.py:42, test.py:44)
    adapter = AdapterConfig(
        adapter_type=adapter_type,
        in_dim=clip_cfg.embed_dim,
        d_model=adapter_dict.pop("d_model", 256),
        num_heads=adapter_dict.pop("num_heads", 4),
        ffn_dim=adapter_dict.pop("ffn_dim", 1024),
        num_layers=adapter_dict.pop("num_layers", 2),
        residual=residual,
    )
    lora = clip_dict.get("lora", -1)
    # a bool counts as an int, as in the JAX package: True enables LoRA
    # mode, and parse_lora_spec(True) then builds no deltas (tower frozen)
    lora_enabled = isinstance(lora, str) or (isinstance(lora, int)
                                             and lora > 0)
    ft_mode = "full"
    if params_cfg.model == "FTCLIP":
        if lora_enabled:
            ft_mode = "lora"
        else:
            for flag, mode in (("only_conv1", "conv1"), ("only_bias", "bias"),
                               ("only_ln", "ln"), ("only_cls_fc", "cls_fc"),
                               ("only_cls_token", "cls_token")):
                if clip_dict.get(flag):
                    ft_mode = mode
                    break
    # exactly one loss; without a loss_dict, logits CE (every shipped
    # reference config's choice); a partial dict fills the other with False
    loss_dict = dict(params_cfg.get("loss_dict", {}) or {})
    if not loss_dict:
        use_logits, use_probs = True, False
    else:
        use_logits = bool(loss_dict.get("use_logits_loss", False))
        use_probs = bool(loss_dict.get("use_probs_loss", False))
    assert int(use_logits) + int(use_probs) == 1, (
        "exactly one of use_logits_loss/use_probs_loss must be set, got "
        f"{loss_dict}")
    return ClassifierConfig(
        model=params_cfg.model,
        clip=clip_cfg,
        # config override is for debug/random towers; real checkpoints
        # override it at load (engine.trainer.snapshot_logit_scale)
        logit_scale=float(clip_dict.get("logit_scale", 100.0)),
        agg_func=clip_dict.get("agg_func", "mean"),
        adapter=adapter,
        prompt_tuning=prompt_tuning,
        lora=lora if lora_enabled else None,
        ft_mode=ft_mode,
        use_logits_loss=use_logits,
        use_probs_loss=use_probs,
        dtype=dtype,
        remat=bool(params_cfg.get("remat", params_cfg.model == "FTCLIP")),
    )


def normalize(x: torch.Tensor, dim: int = -1,
              eps: float = 1e-12) -> torch.Tensor:
    """L2 normalize; zero vectors stay zero (torch F.normalize semantics)."""
    n = torch.linalg.vector_norm(x, dim=dim, keepdim=True)
    return x / torch.clamp(n, min=eps)


def tokenize_prompts(class_names: Sequence[str], prompt: str,
                     tokenizer: SimpleTokenizer,
                     context_length: int) -> np.ndarray:
    """Class names -> [n_cls, context] prompted token ids: lowercased,
    underscores to spaces, formatted into `prompt` (reference
    models/clip_cls.py:64-93)."""
    names = [c.lower().replace("_", " ") for c in class_names]
    return tokenize([prompt.format(c) for c in names], tokenizer,
                    context_length)


@torch.no_grad()
def compute_text_features(clip, tokens: torch.Tensor) -> torch.Tensor:
    """Prompt token ids [n_cls, context] -> L2-normalized features
    [n_cls, C] (the text tower runs in f32, as the JAX package's)."""
    return normalize(encode_text(clip.text, tokens))


def class_text_features(clip, class_names: Sequence[str], prompt: str,
                        tokenizer: SimpleTokenizer) -> torch.Tensor:
    """Class names -> L2-normalized prompted text features [n_cls, C]
    (the JAX package's `compute_text_features`)."""
    tokens = tokenize_prompts(class_names, prompt, tokenizer,
                              clip.text.cfg.context_length)
    return compute_text_features(clip, torch.from_numpy(tokens).to(
        clip.logit_scale.device))


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------


class ClassifierParams(nn.Module):
    """The classifier's parameter tree (the JAX package's
    {'clip', 'text_feats', 'adapter', 'lora'} dict): CLIP towers, [n_cls, C]
    text features (trainable only under prompt tuning), for FS the view
    adapter and, for FT with LoRA, the stacked deltas. Which parameters
    train is set by models.partition.set_trainable."""

    def __init__(self, clip: CLIP, text_feats: torch.Tensor,
                 lora: Optional[LoRA] = None,
                 adapter: Optional[Adapter] = None):
        super().__init__()
        self.clip = clip
        # a copy: the caller's tensor (maybe made under inference_mode)
        # never becomes a parameter itself
        self.text_feats = nn.Parameter(torch.as_tensor(
            text_feats, dtype=torch.float32).to(
                clip.logit_scale.device).clone())
        self.lora = lora
        self.adapter = adapter


@torch.no_grad()
def init_classifier_params(cfg: ClassifierConfig,
                           generator: torch.Generator,
                           clip: Optional[CLIP] = None,
                           text_feats: Optional[torch.Tensor] = None,
                           n_classes: Optional[int] = None,
                           device=None) -> ClassifierParams:
    """Assemble the parameters, drawing what is not given from `generator`
    in the order towers, text features, adapter (FS) or LoRA (FT).
    `text_feats` seeds the
    prompt-tuning parameter (the reference initializes the prompts from the
    frozen encoder output, clip_cls.py:253-259) or is the frozen cache."""
    device = generator.device if device is None else torch.device(device)
    if clip is None:
        clip = init_clip_params(cfg.clip, generator, device=device)
    if text_feats is None:
        assert n_classes is not None
        text_feats = normalize(torch.randn(
            (n_classes, cfg.clip.embed_dim), generator=generator,
            device=generator.device))
    lora = adapter = None
    if cfg.model == "FSCLIP":
        adapter = init_adapter_params(cfg.adapter, generator, device=device)
    if cfg.model == "FTCLIP" and cfg.lora is not None:
        lora = init_lora_params(cfg.clip.vision, cfg.lora, generator,
                                device=device)
    return ClassifierParams(clip, text_feats, lora, adapter)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


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


def _encode_views(params: ClassifierParams, cfg: ClassifierConfig,
                  flat_imgs: torch.Tensor, train: bool,
                  tp=None) -> torch.Tensor:
    """[V, 3, S, S] -> [V, C] raw (un-normalized) f32 encoder features,
    through the ViT or, for a ResNet config, the ResNet tower. Only FT
    records a graph through the tower; ZS and FS encode under
    no_grad (the frozen tower, the JAX package's stop_gradient). `tp` (a
    parallel/sharding.py TPContext) runs the ViT's blocks
    tensor-parallel; a ResNet tower has none to split."""
    trains_tower = cfg.model == "FTCLIP"
    with torch.set_grad_enabled(trains_tower and torch.is_grad_enabled()):
        if isinstance(cfg.clip.vision, ResNetVisionConfig):
            # keep_tokens is a ViT option: a ResNet ignores it
            assert params.lora is None, \
                "LoRA targets the ViT attention (lora.py:385)"
            return encode_image_resnet(params.clip.visual, flat_imgs,
                                       dtype=cfg.dtype)
        return encode_image(
            params.clip.visual, flat_imgs, dtype=cfg.dtype, lora=params.lora,
            remat=cfg.remat and trains_tower and train,
            keep_tokens=None if train else cfg.keep_tokens, tp=tp).float()


def classifier_forward(params: ClassifierParams, cfg: ClassifierConfig,
                       imgs: torch.Tensor, valid: torch.Tensor,
                       train: bool = False,
                       generator: Optional[torch.Generator] = None,
                       tp=None) -> Dict[str, torch.Tensor]:
    """imgs [B, T, 3, S, S] CLIP-normalized, valid [B, T] -> output dict.

    All T views are encoded (padded views carry zeros) and masked after.
    `train` with a `generator` turns on the FS adapter's dropout; `tp`
    runs the visual blocks tensor-parallel."""
    B, T = valid.shape
    flat = imgs.reshape((B * T,) + tuple(imgs.shape[2:]))
    feats = _encode_views(params, cfg, flat, train, tp=tp).reshape(B, T, -1)
    return _aggregate_head(params, cfg, feats, valid, train, generator, tp)


def classifier_forward_packed(params: ClassifierParams,
                              cfg: ClassifierConfig, imgs: torch.Tensor,
                              view_src: torch.Tensor,
                              valid: torch.Tensor,
                              tp=None) -> Dict[str, torch.Tensor]:
    """Forward over view-PACKED images (only valid views encoded).

    imgs [K, 3, S, S] holds the batch's valid views compacted across
    samples; view_src [K] maps each row to its flat slot in [B*T] (the
    sentinel B*T marks packing padding, summed into a spare slot that is
    dropped)."""
    feats_k = _encode_views(params, cfg, imgs, train=False, tp=tp)
    return classifier_head_packed(params, cfg, feats_k, view_src, valid, tp)


def classifier_head_packed(params: ClassifierParams, cfg: ClassifierConfig,
                           feats_k: torch.Tensor, view_src: torch.Tensor,
                           valid: torch.Tensor,
                           tp=None) -> Dict[str, torch.Tensor]:
    """The packed forward after the encoder: [K, C] view features put back
    in their [B*T] slots (the sentinel's into a spare slot, dropped), then
    the head."""
    B, T = valid.shape
    C = feats_k.shape[-1]
    flat = torch.zeros((B * T + 1, C), dtype=torch.float32,
                       device=feats_k.device)
    flat = flat.index_add(0, view_src.to(torch.int64), feats_k)
    feats = flat[: B * T].reshape(B, T, C)
    return _aggregate_head(params, cfg, feats, valid, tp=tp)


def classifier_head(params: ClassifierParams, cfg: ClassifierConfig,
                    feats: torch.Tensor, valid: torch.Tensor
                    ) -> Dict[str, torch.Tensor]:
    """The eval forward after the encoder: [B*T, C] view features of a
    padded batch -> the output dict."""
    B, T = valid.shape
    return _aggregate_head(params, cfg, feats.reshape(B, T, -1), valid)


class _AdapterCall(nn.Module):
    """`apply_adapter` as a module call, so `functional_call` can run it on
    whole leaves gathered from model shards."""

    def __init__(self, adapter: Adapter):
        super().__init__()
        self.adapter = adapter

    def forward(self, cfg, feats, valid, train, generator):
        return apply_adapter(self.adapter, cfg, feats, valid, train=train,
                             generator=generator)


def _aggregate_head(params: ClassifierParams, cfg: ClassifierConfig,
                    feats: torch.Tensor, valid: torch.Tensor,
                    train: bool = False,
                    generator: Optional[torch.Generator] = None,
                    tp=None) -> Dict[str, torch.Tensor]:
    """Post-encoder half: FS adapts the features (zeros in padded slots
    are masked out of its attention), FS and FT normalize then mask them
    (ZS uses them raw, clip_cls.py:148), then logits against the text
    features, masked, aggregated. Under `tp` the adapter's stacked blocks
    are model shards (the JAX rule shards every `blocks` path) on
    replicated features: they are gathered whole for its forward, and
    each rank keeps its piece of their (replicated) gradient."""
    if cfg.model == "FSCLIP":
        with record_function("adapter"):
            call = _AdapterCall(params.adapter)
            whole = {}
            if tp is not None and params.adapter is not None:
                from ..parallel.sharding import gather_model

                whole = gather_model(call.named_parameters(), "adapter.",
                                     params.placements, tp)
            args = (cfg.adapter, feats, valid, train, generator)
            feats = (torch.func.functional_call(call, whole, args,
                                                strict=False)
                     if whole else call(*args))
    if cfg.model != "ZSCLIP":
        # FT bypasses the adapter (clip_cls_ft.py:228)
        feats = normalize(feats) * valid[..., None]
    with record_function("text_feats"):
        text_feats = params.text_feats
        if cfg.prompt_tuning:
            text_feats = normalize(text_feats)  # re-normalized every forward
        else:
            text_feats = text_feats.detach()
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


# ---------------------------------------------------------------------------
# losses & metrics
# ---------------------------------------------------------------------------


def _log_probs(cfg: ClassifierConfig, out: Dict[str, torch.Tensor]):
    if cfg.use_logits_loss:
        return torch.log_softmax(out["logits"], dim=-1)
    return torch.log(out["probs"] + 1e-6)


def per_sample_ce(cfg: ClassifierConfig, out: Dict[str, torch.Tensor],
                  labels: torch.Tensor) -> torch.Tensor:
    """[B] cross-entropy over aggregated logits, or NLL over aggregated
    probs (clip_cls.py:164-175)."""
    logp = _log_probs(cfg, out)
    return -logp.gather(-1, labels.long()[:, None])[:, 0]


def train_loss(cfg: ClassifierConfig, out: Dict[str, torch.Tensor],
               labels: torch.Tensor) -> Dict[str, torch.Tensor]:
    return {"ce_loss": per_sample_ce(cfg, out, labels).mean()}


def eval_metrics(cfg: ClassifierConfig, out: Dict[str, torch.Tensor],
                 labels: torch.Tensor) -> Dict[str, torch.Tensor]:
    m = train_loss(cfg, out, labels)
    m["probs_acc"] = (out["probs"].argmax(-1) == labels).float().mean()
    m["logits_acc"] = (out["logits"].argmax(-1) == labels).float().mean()
    return m
