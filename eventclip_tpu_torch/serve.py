"""Batch inference API: raw event streams -> class predictions, on the card.

Port of eventclip_tpu/serve.py::Predictor (zero-shot): window gathering on
the host -> histogram kernel, frame finish and CLIP preprocess on the
device -> CLIP ViT (fused-qkv attention kernel) -> aggregation against
text features. Requests of any size are cut into chunks of the batch size
(the tail padded), and chunks with idle view slots run view-PACKED at one
of 4 bucketed view counts, so short streams never pay for empty encodes.
`tta=True` averages the probabilities over the 4 event-TTA variants
(identity, h-flip, t-flip, both).

Example:
    from eventclip_tpu_torch.serve import Predictor
    pred = Predictor.from_config("configs/zsclip/zsclip_ncaltech_params.py",
                                 class_names=names, smoke=True)
    out = pred(list_of_event_arrays)       # {'label', 'probs', 'names', 'topk'}

Released CLIP weights load from `clip_ckpt` (an OpenAI `.pt` or a
converted `.npz`); without `text_feats`, the config's prompt goes through
the BPE tokenizer and the text tower. Later slices (ROADMAP item 3):
`weight=`, `embed`, `set_classes`, `StreamSession`, int8, token pruning,
data parallelism.
"""

from __future__ import annotations

import zlib
from typing import Any, Dict, List, Sequence

import numpy as np
import torch

from .data.datasets import DATASET_CLASSES
from .data.event_windows import parse_quantize_args
from .data.host_ops import gather_event_windows, prepare_stream, tta_variants
from .data.loader import eval_pack_buckets, pack_view_batch
from .engine.trainer import (build_text_features, copy_clip,
                             resolve_clip_params, snapshot_logit_scale)
from .models.classifier import (DEFAULT_PROMPT, ClassifierParams,
                                build_classifier_config, classifier_forward,
                                classifier_forward_packed)
from .models.clip.config import clip_arch_config
from .ops.preprocess import ClipPreprocess
from .ops.rasterize import RasterSpec, rasterize_for_clip
from .utils.config import load_params


class Predictor:
    """Event-stream classifier on one device (see module docstring).

    clip_ckpt: released CLIP weights (an OpenAI `.pt` or a converted
        `.npz`; the config's `clip_ckpt` when omitted): pretrained towers,
        whose logit scale replaces the config's.
    clip_params: optional CLIP towers instead, a port `CLIP` module or the
        JAX package's parameter tree as numpy arrays (crossed by
        models/clip/convert.py); treated as not pretrained (the logit scale
        stays the config's). Without either, random towers (smoke/debug
        only).
    text_feats: optional numpy/tensor [n_cls, C] L2-normalized class
        features; without it, the config's prompt through the tokenizer
        (random features for random towers when the vocab is missing).
    """

    def __init__(
        self,
        params,
        class_names: Sequence[str],
        *,
        clip_ckpt=None,
        clip_params=None,
        text_feats=None,
        smoke: bool = False,
        batch_size: int = 32,
        pack_views: bool = True,
        tta: bool = False,
        device="cuda",
    ):
        self.device = torch.device(device)
        self.class_names = list(class_names)
        self.batch_size = int(batch_size)
        self.tta = bool(tta)

        # sensor geometry + view budget from the config's dataset stats;
        # the eval view budget is the reference's forced max_imgs=10
        ds = DATASET_CLASSES[params.dataset]
        self.window, self.views, raster_args = parse_quantize_args(
            params.quantize_args, ds.resolution, ds.max_n, hard_limit=10
        )
        self.resolution = ds.resolution
        self._spec = RasterSpec(**raster_args)

        clip_cfg = clip_arch_config(params.clip_dict["arch"])
        dtype = torch.bfloat16 if bool(params.get("bf16", True)) \
            else torch.float32
        self._cfg = build_classifier_config(params, clip_cfg, dtype=dtype)
        if clip_params is None:
            gen = torch.Generator(device=self.device).manual_seed(0)
            clip, pretrained = resolve_clip_params(
                params, clip_cfg, gen, clip_ckpt, smoke=smoke,
                device=self.device)
        else:
            clip, pretrained = copy_clip(clip_params, clip_cfg,
                                         self.device), False
        self._cfg = snapshot_logit_scale(self._cfg, clip, pretrained)
        if text_feats is None:
            text_feats = build_text_features(
                clip, clip_cfg, self.class_names,
                params.clip_dict.get("prompt", DEFAULT_PROMPT), pretrained)
        self._params = ClassifierParams(clip, torch.as_tensor(
            np.array(text_feats, dtype=np.float32)
            if isinstance(text_feats, np.ndarray) else text_feats,
            dtype=torch.float32))
        self._pp = ClipPreprocess(in_height=ds.resolution[0],
                                  in_width=ds.resolution[1],
                                  image_size=clip_cfg.vision.image_size)
        self._buckets = (eval_pack_buckets(self.batch_size, self.views, 1)
                         if pack_views else None)

    # -- host half -----------------------------------------------------------

    def _prep(self, events: np.ndarray) -> tuple:
        """Validate + canonicalize one stream -> (centered events, rng)."""
        # own copy: the polarity remap below is in place and must never
        # mutate the caller's array (or the content hash)
        events = np.array(events, dtype=np.float32, copy=True)
        assert events.ndim == 2 and events.shape[1] == 4, (
            f"expected [n, 4] x/y/t/p events, got {events.shape}"
        )
        if events.shape[0] == 0:
            raise ValueError(
                "empty event stream (0 events) — an idle sensor window has "
                "no defined prediction; filter empty streams before predict()"
            )
        if events[:, 3].min() >= -0.5:
            # 0/1 polarity encoding -> ±1 (the rasterizer treats p == 0 as
            # padding, so unmapped 0/1 would drop every negative event)
            events[:, 3] = np.where(events[:, 3] <= 0.5, -1.0, 1.0)
        # view subsampling must be deterministic and independent of the
        # stream's position in the request: seed from the stream content
        rng = np.random.default_rng(
            zlib.crc32(np.ascontiguousarray(events).tobytes())
        )
        return prepare_stream(events, self.resolution), rng

    def _windows(self, events: np.ndarray) -> tuple:
        events, rng = self._prep(events)
        return gather_event_windows(
            events, self.window, self.views, rng=rng, packed=True
        )

    def _windows_tta(self, events: np.ndarray) -> tuple:
        """4 variants -> ([4, V, N, 3] int16, [4, V] bool) in the order
        identity, h-flip, t-flip, both; the 4 gathers consume ONE
        content-seeded rng in sequence (the dataset's TTA draw order)."""
        events, rng = self._prep(events)
        pairs = [
            gather_event_windows(v, self.window, self.views, rng=rng,
                                 packed=True)
            for v in tta_variants(events, self.resolution)
        ]
        return (np.stack([w for w, _ in pairs]),
                np.stack([m for _, m in pairs]))

    # -- public API ----------------------------------------------------------

    def __call__(self, event_streams) -> Dict[str, Any]:
        return self.predict(event_streams)

    def predict(self, event_streams: List[np.ndarray], top_k: int = 1
                ) -> Dict[str, Any]:
        """Classify raw event streams.

        event_streams: list of [n, 4] float arrays (x, y, t in s, p ±1/0-1).
        Returns {'label': [B] int, 'names': [B] str, 'probs': [B, C] f32,
        'topk': [B, top_k] int} with rows aligned to the input order.
        """
        if not len(event_streams):
            n_cls = len(self.class_names)
            return {
                "label": np.zeros((0,), np.int64), "names": [],
                "probs": np.zeros((0, n_cls), np.float32),
                "topk": np.zeros((0, min(top_k, n_cls)), np.int64),
            }
        wins, valids = self.gather_windows(event_streams)
        return self.predict_windows(wins, valids, top_k=top_k)

    def gather_windows(self, event_streams) -> tuple:
        """Host half: validate + window every stream -> stacked
        ([B, V, N, 3] int16, [B, V] bool); with tta=True every stream
        contributes 4 consecutive variant rows ([B*4, ...])."""
        windower = self._windows_tta if self.tta else self._windows
        pairs = []
        for i, e in enumerate(event_streams):
            try:
                pairs.append(windower(e))
            except (ValueError, AssertionError) as err:
                raise ValueError(f"event_streams[{i}]: {err}") from None
        wins, valids = zip(*pairs)
        wins, valids = np.stack(wins), np.stack(valids)
        if self.tta:  # [B, 4, V, ...] -> [B*4, V, ...], variant-major rows
            wins = wins.reshape((-1,) + wins.shape[2:])
            valids = valids.reshape((-1,) + valids.shape[2:])
        return wins, valids

    def predict_windows(self, wins: np.ndarray, valids: np.ndarray,
                        top_k: int = 1) -> Dict[str, Any]:
        """Device phase on pre-gathered windows (`gather_windows` output)."""
        probs = self._run_chunked(wins, valids, self._dispatch_chunk)
        return self.finalize(probs, top_k)

    def _run_chunked(self, wins: np.ndarray, valids: np.ndarray,
                     dispatch) -> np.ndarray:
        """Split into batch-size chunks (padding the tail), place + run
        each, concatenate the per-row outputs (one host fetch at the end)."""
        bs = self.batch_size
        out = []
        for i in range(0, len(wins), bs):
            w, v = wins[i:i + bs], valids[i:i + bs]
            pad = bs - len(w)
            if pad:  # fixed batch; padded rows sliced off below
                w = np.concatenate(
                    [w, np.zeros((pad,) + w.shape[1:], w.dtype)])
                v = np.concatenate(
                    [v, np.zeros((pad,) + v.shape[1:], bool)])
            out.append(dispatch(self._place_chunk(w, v))[: bs - pad])
        return torch.cat(out).cpu().numpy()[: len(wins)]

    def _place_chunk(self, wins: np.ndarray, valids: np.ndarray
                     ) -> Dict[str, torch.Tensor]:
        """One [batch_size, V, ...] host chunk -> device batch (view-packed
        when a bucket fits)."""
        batch = {"windows": wins, "valid_mask": valids}
        if self._buckets:
            batch = pack_view_batch(batch, self._buckets)
        return {k: torch.from_numpy(np.ascontiguousarray(x)).to(self.device)
                for k, x in batch.items()}

    @torch.inference_mode()
    def _forward(self, batch: Dict[str, torch.Tensor]
                 ) -> Dict[str, torch.Tensor]:
        """The device step: rasterize -> preprocess -> classifier, packed
        when the batch carries `view_src`, padded otherwise."""
        x = rasterize_for_clip(self._spec, self._pp, batch["windows"])
        if "view_src" in batch:
            return classifier_forward_packed(
                self._params, self._cfg, x, batch["view_src"],
                batch["valid_mask"])
        return classifier_forward(self._params, self._cfg, x,
                                  batch["valid_mask"])

    def _dispatch_chunk(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        return self._forward(batch)["probs"]

    def warm_up(self) -> None:
        """Run every encoder shape a request can select once (one per
        packing bucket, or the padded one), so kernel builds, library
        initialization and allocator growth happen before traffic."""
        rng = np.random.default_rng(0)
        bs, budget, n = self.batch_size, self.views, self.window
        h, w = self.resolution

        def chunk(n_valid):
            wins = np.stack([
                rng.integers(0, w, (bs, budget, n)),
                rng.integers(0, h, (bs, budget, n)),
                np.where(rng.random((bs, budget, n)) < 0.5, -1, 1),
            ], axis=-1).astype(np.int16)  # packed (x, y, p) layout
            valids = np.zeros(bs * budget, bool)
            valids[:n_valid] = True
            return wins, valids.reshape(bs, budget)

        total = bs * budget
        targets = [min(k, total) for k in (self._buckets or [total])]
        for want in targets:
            self._dispatch_chunk(self._place_chunk(*chunk(want))).cpu()

    def finalize(self, probs: np.ndarray, top_k: int = 1) -> Dict[str, Any]:
        """Per-variant-row probabilities -> the prediction dict. With TTA,
        every 4 consecutive rows are one stream's variants and collapse to
        their mean."""
        if self.tta:
            probs = probs.reshape(-1, 4, probs.shape[-1]).mean(axis=1)
        label = probs.argmax(-1)
        k = min(int(top_k), probs.shape[-1])
        topk = np.argsort(-probs, axis=-1)[:, :k]
        return {
            "label": label,
            "names": [self.class_names[i] for i in label],
            "probs": probs,
            "topk": topk,
        }

    @classmethod
    def from_config(cls, config_path: str, class_names: Sequence[str],
                    **kwargs) -> "Predictor":
        """Build from an experiment config file (the CLIs' --params)."""
        return cls(load_params(config_path), class_names, **kwargs)
