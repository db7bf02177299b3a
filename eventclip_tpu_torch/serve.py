"""Batch inference API: raw event streams -> class predictions, on the card.

Port of eventclip_tpu/serve.py: window gathering on the host (the native
host-ops library when it loads) -> histogram kernel, frame finish and CLIP
preprocess on the device -> CLIP ViT (fused-qkv attention kernel) ->
aggregation against text features. Requests of any size are cut into
chunks of the batch size (the tail padded), and chunks with idle view
slots run view-PACKED at one of 4 bucketed view counts, so short streams
never pay for empty encodes.

Options, as the JAX package's:
- `weight=`: serve a trained FS/FT checkpoint (`.npz` of either package,
  or the reference's `.pth`); trainable models refuse to serve without one;
- `int8=True`: the W8A8 int8 visual tower (ops/quant.py), dynamic
  per-token activation scales, or static ones calibrated on
  `int8_calib_streams` through the production windowing;
- `prune_tokens=K`: keep the K highest-variance patches of each view;
- `tta=True`: probabilities averaged over the 4 event-TTA variants
  (identity, h-flip, t-flip, both);
- `embed=True` + `embed()`: one L2-normalized CLIP feature per stream;
- `set_classes()`: swap the label set at run time (one text-tower pass);
- `StreamSession`: a rolling prediction over a live stream's newest events.

Example:
    from eventclip_tpu_torch.serve import Predictor
    pred = Predictor.from_config("configs/zsclip/zsclip_ncaltech_params.py",
                                 class_names=names, smoke=True)
    out = pred(list_of_event_arrays)       # {'label', 'probs', 'names', 'topk'}

Released CLIP weights load from `clip_ckpt` (an OpenAI `.pt` or a
converted `.npz`); without `text_feats`, the config's prompt goes through
the BPE tokenizer and the text tower. Offline batch inference over files:
`python -m eventclip_tpu_torch.serve --help` (`--from_export` serves a
frozen bundle of export.py); the HTTP endpoint is server.py.
`data_parallel=True` replicates the model on every local card (or on an
explicit `devices` list) and splits each batch over them
(parallel/local.py), as the JAX package shards it over its local mesh.
"""

from __future__ import annotations

import collections
import copy
import dataclasses
import threading
import zlib
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from .data.datasets import DATASET_CLASSES, build_dataset, load_event_npz
from .data.event_windows import parse_quantize_args
from .data.host_ops import gather_event_windows, prepare_stream, tta_variants
from .data.loader import eval_pack_buckets, pack_view_batch
from .engine.checkpoint import load_checkpoint
from .engine.trainer import (build_text_features, copy_clip,
                             resolve_clip_params, snapshot_logit_scale)
from .models.classifier import (DEFAULT_PROMPT, build_classifier_config,
                                classifier_forward, classifier_forward_packed,
                                init_classifier_params, normalize)
from .models.clip.config import clip_arch_config
from .models.clip.model import refuse_option
from .ops.preprocess import ClipPreprocess
from .ops.quant import calibrate_visual_amax, quantize_classifier_params
from .ops.rasterize import RasterSpec, rasterize_for_clip
from .parallel.local import LocalSplit, local_devices
from .utils.config import load_params
from .utils.spans import span


class Predictor:
    """Event-stream classifier on one device (see module docstring).

    weight: a trained checkpoint for FS/FT configs (required for them).
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
    data_parallel: replicate the model on every visible card (`devices`,
        when given, names them: `["cpu", "cpu"]`, `[cuda:0, cuda:0]`) and
        split each batch into equal parts over them; `batch_size` is
        rounded down to a multiple of the part count.
    """

    def __init__(
        self,
        params,
        class_names: Sequence[str],
        *,
        weight: str = "",
        clip_ckpt=None,
        clip_params=None,
        text_feats=None,
        smoke: bool = False,
        int8: bool = False,
        int8_calib_streams: Optional[Sequence[Any]] = None,
        prune_tokens: int = 0,
        batch_size: int = 32,
        data_parallel: bool = False,
        pack_views: bool = True,
        tta: bool = False,
        embed: bool = False,
        device="cuda",
        devices: Optional[Sequence] = None,
    ):
        # trainable models served without a checkpoint would classify with
        # random adapter/LoRA/prompt weights (the eval CLI's rule too)
        if params.model != "ZSCLIP" and not weight:
            raise ValueError(
                f"{params.model} has trainable weights; pass weight=<ckpt> "
                "(serving it untrained would return random-adapter garbage). "
                "Only ZSCLIP may be served without a checkpoint."
            )
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
        # refused here rather than at the first request
        if prune_tokens > 0:
            refuse_option(clip_cfg.vision, "token pruning")
            self._cfg = dataclasses.replace(self._cfg,
                                            keep_tokens=int(prune_tokens))
        if dtype != torch.bfloat16 and self.device.type == "cuda":
            refuse_option(clip_cfg.vision, "f32 on the card")
        gen = torch.Generator(device=self.device).manual_seed(0)
        if clip_params is None:
            clip, pretrained = resolve_clip_params(
                params, clip_cfg, gen, clip_ckpt, smoke=smoke,
                device=self.device)
        else:
            clip, pretrained = copy_clip(clip_params, clip_cfg,
                                         self.device), False
        self._cfg = snapshot_logit_scale(self._cfg, clip, pretrained)
        # kept for set_classes (a label swap re-prompts the text tower)
        self._prompt = params.clip_dict.get("prompt", DEFAULT_PROMPT)
        self._pretrained = pretrained
        if text_feats is None:
            text_feats = build_text_features(
                clip, clip_cfg, self.class_names, self._prompt, pretrained)
        elif isinstance(text_feats, np.ndarray):
            text_feats = np.array(text_feats, dtype=np.float32)  # writable
        model_params = init_classifier_params(
            self._cfg, gen, clip=clip, text_feats=text_feats,
            device=self.device)
        self._pp = ClipPreprocess(in_height=ds.resolution[0],
                                  in_width=ds.resolution[1],
                                  image_size=clip_cfg.vision.image_size)
        if weight:
            load_checkpoint(weight, target=model_params)
        if int8:
            act_amax = None
            if int8_calib_streams is not None and len(int8_calib_streams):
                # static activation scales fitted on the FLOAT tower over
                # the given streams, windowed and rasterized as traffic is
                wins, _ = self.gather_windows(list(int8_calib_streams))
                w = torch.from_numpy(wins).to(self.device)
                with torch.no_grad():
                    imgs = rasterize_for_clip(
                        self._spec, self._pp,
                        w.reshape((-1,) + tuple(w.shape[-2:])))
                act_amax = calibrate_visual_amax(
                    model_params.clip.visual, imgs, dtype=dtype)
            model_params = quantize_classifier_params(model_params,
                                                      act_amax=act_amax)
        self._params = model_params
        # the device step runs through a split of one part on the
        # predictor's device; data_parallel: the model once on each local
        # card, each batch split over them (the eval CLI's DP layout)
        self.data_parallel = bool(data_parallel)
        self._split = LocalSplit(model_params, (
            devices or local_devices(self.device)) if data_parallel
            else [self.device])
        n_data = self._split.n
        self.batch_size = max(self.batch_size - self.batch_size % n_data,
                              n_data)
        self._embed = bool(embed)
        self._buckets = (eval_pack_buckets(self.batch_size, self.views,
                                           n_data) if pack_views else None)

    # -- host half -----------------------------------------------------------

    def _canonical(self, events: np.ndarray) -> tuple:
        """Validate one stream -> (an own float32 copy with ±1 polarity,
        the rng seeded from its content)."""
        with span("serve.canonical"):
            # own copy: the polarity remap below is in place and must never
            # mutate the caller's array (or the content hash)
            events = np.array(events, dtype=np.float32, copy=True)
            assert events.ndim == 2 and events.shape[1] == 4, (
                f"expected [n, 4] x/y/t/p events, got {events.shape}"
            )
            if events.shape[0] == 0:
                raise ValueError(
                    "empty event stream (0 events) — an idle sensor window "
                    "has no defined prediction; filter empty streams before "
                    "predict()"
                )
            if events[:, 3].min() >= -0.5:
                # 0/1 polarity encoding -> ±1 (the rasterizer treats p == 0
                # as padding, so unmapped 0/1 would drop every negative
                # event)
                events[:, 3] = np.where(events[:, 3] <= 0.5, -1.0, 1.0)
        # view subsampling must be deterministic and independent of the
        # stream's position in the request: seed from the stream content
        with span("serve.seed"):
            rng = np.random.default_rng(
                zlib.crc32(np.ascontiguousarray(events).tobytes())
            )
        return events, rng

    def _prep(self, events: np.ndarray) -> tuple:
        """Validate + canonicalize + center one stream -> (events, rng)."""
        events, rng = self._canonical(events)
        with span("serve.centre"):
            return prepare_stream(events, self.resolution), rng

    def _windows(self, events: np.ndarray) -> tuple:
        events, rng = self._prep(events)
        with span("serve.window"):
            return gather_event_windows(
                events, self.window, self.views, rng=rng, packed=True
            )

    def _windows_tta(self, events: np.ndarray) -> tuple:
        """4 variants -> ([4, V, N, 3] int16, [4, V] bool) in the order
        identity, h-flip, t-flip, both; the 4 gathers consume ONE
        content-seeded rng in sequence (the dataset's TTA draw order)."""
        events, rng = self._prep(events)
        with span("serve.window"):
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
        # one root span over both halves (utils/spans.py)
        with span("serve.predict"):
            wins, valids = self.gather_windows(event_streams)
            return self.predict_windows(wins, valids, top_k=top_k)

    def gather_windows(self, event_streams) -> tuple:
        """Host half: validate + window every stream -> stacked
        ([B, V, N, 3] int16, [B, V] bool); with tta=True every stream
        contributes 4 consecutive variant rows ([B*4, ...])."""
        windower = self._windows_tta if self.tta else self._windows
        with span("serve.gather_windows"):
            pairs = []
            for i, e in enumerate(event_streams):
                try:
                    pairs.append(windower(e))
                except (ValueError, AssertionError) as err:
                    raise ValueError(f"event_streams[{i}]: {err}") from None
            with span("serve.stack"):
                wins, valids = zip(*pairs)
                wins, valids = np.stack(wins), np.stack(valids)
            if self.tta:  # [B, 4, V, ...] -> [B*4, V, ...], variant-major
                wins = wins.reshape((-1,) + wins.shape[2:])
                valids = valids.reshape((-1,) + valids.shape[2:])
        return wins, valids

    def predict_windows(self, wins: np.ndarray, valids: np.ndarray,
                        top_k: int = 1) -> Dict[str, Any]:
        """Device phase on pre-gathered windows (`gather_windows` output)."""
        with span("serve.predict_windows"):
            probs = self._run_chunked(wins, valids, self._dispatch_chunk)
            return self.finalize(probs, top_k)

    def _run_chunked(self, wins: np.ndarray, valids: np.ndarray,
                     dispatch, pack: bool = True) -> np.ndarray:
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
            batch = self._place_chunk(w, v, pack)
            # the host issues the device step; the card runs it after
            with span("serve.enqueue"):
                out.append(dispatch(batch)[: bs - pad])
        # the host waits for the card here, then copies the rows back
        with span("serve.fetch"):
            return torch.cat(out).cpu().numpy()[: len(wins)]

    def _place_chunk(self, wins: np.ndarray, valids: np.ndarray,
                     pack: bool = True) -> Dict[str, torch.Tensor]:
        """One [batch_size, V, ...] host chunk -> device batch (view-packed
        when a bucket fits; pack=False keeps it padded, as embed runs)."""
        batch = {"windows": wins, "valid_mask": valids}
        if pack and self._buckets:
            with span("serve.pack") as s:
                batch = pack_view_batch(batch, self._buckets)
                if s:
                    s.count(valid_views=int(valids.sum()),
                            packed_views=len(batch["view_src"])
                            if "view_src" in batch else valids.size)
        # a split places each part of the windows on its own card
        host = ("windows",) if self.data_parallel and self._split.n > 1 \
            else ()
        with span("serve.place"):
            return {k: torch.from_numpy(np.ascontiguousarray(x)) if k in host
                    else torch.from_numpy(np.ascontiguousarray(x)).to(
                        self.device)
                    for k, x in batch.items()}

    @torch.inference_mode()
    def _forward(self, batch: Dict[str, torch.Tensor]
                 ) -> Dict[str, torch.Tensor]:
        """The device step on this predictor's weights, over its split
        (one part unless data-parallel)."""
        return self._split.forward(self._cfg, self._spec, self._pp,
                                   batch["windows"], batch["valid_mask"],
                                   batch.get("view_src"))

    def _dispatch_chunk(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        return self._forward(batch)["probs"]

    @torch.inference_mode()
    def _embed_chunk(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Padded chunk -> [B, C] embeddings (`embed_features`)."""
        return embed_features(self._forward(batch), batch["valid_mask"])

    def warm_up(self, log=None) -> None:
        """Run every encoder shape a request can select once (one per
        packing bucket, or the padded one; with embed=True also the padded
        embed program), so allocator growth and library initialization
        happen before traffic. Crafting device chunks, not streams, makes
        the coverage exact for every batch_size / tta combination. `log`
        (e.g. `print`) reports each program as it runs."""
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
        # pack_view_batch picks the smallest bucket >= the valid count, so
        # n_valid=k lands exactly on bucket k (capped at the batch's slots)
        targets = [min(k, total) for k in (self._buckets or [total])]
        for i, want in enumerate(targets):
            if log is not None:
                log(f"warm-up: program {i + 1}/{len(targets)} "
                    f"(valid views={want})...")
            self._dispatch_chunk(self._place_chunk(*chunk(want))).cpu()
        if self._embed:
            if log is not None:
                log("warm-up: the embed program...")
            self._embed_chunk(self._place_chunk(*chunk(total),
                                                pack=False)).cpu()

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

    def embed(self, event_streams: List[np.ndarray]) -> np.ndarray:
        """Raw event streams -> [B, C] L2-normalized CLIP features: the mean
        of the per-view features; with tta=True also the mean over the 4
        variants, re-normalized. Requires embed=True at construction."""
        if not self._embed:
            raise RuntimeError(
                "Predictor was built without embed=True — the embeddings "
                "program is opt-in"
            )
        if not len(event_streams):
            dim = int(self._params.text_feats.shape[-1])
            return np.zeros((0, dim), np.float32)
        wins, valids = self.gather_windows(event_streams)
        return self.embed_windows(wins, valids)

    def embed_windows(self, wins: np.ndarray, valids: np.ndarray
                      ) -> np.ndarray:
        """Device phase of embed() on pre-gathered windows, always on the
        padded program (no view packing), as the JAX package's."""
        if not self._embed:
            raise RuntimeError("Predictor was built without embed=True")
        feats = self._run_chunked(wins, valids, self._embed_chunk,
                                  pack=False).astype(np.float32)
        if self.tta:  # [B*4, C] variant rows -> mean per stream, re-norm
            feats = feats.reshape(-1, 4, feats.shape[-1]).mean(axis=1)
            feats /= np.maximum(
                np.linalg.norm(feats, axis=-1, keepdims=True), 1e-12)
        return feats

    def set_classes(self, class_names: Sequence[str]) -> None:
        """Swap the label set at run time: the class head is a product with
        prompted text features, so new labels need one text-tower pass.
        Refused for prompt-tuned checkpoints, whose text features are
        trained parameters. Not synchronized with concurrent predict()
        calls: callers serialize."""
        if self._cfg.prompt_tuning:
            raise ValueError(
                "this checkpoint prompt-tunes its text features (trained "
                "parameters); swapping class names would discard the "
                "tuning — rebuild a Predictor with a matching checkpoint"
            )
        names = [str(n) for n in class_names]
        if not names:
            raise ValueError("class_names must be non-empty")
        feats = build_text_features(self._params.clip, self._cfg.clip, names,
                                    self._prompt, self._pretrained)
        # a copy: features made under inference_mode never become a
        # parameter themselves; every replica of a split takes them
        def swap(params, device):
            params.text_feats = nn.Parameter(
                feats.to(device, torch.float32).clone(), requires_grad=False)

        self._split.update(swap)
        self.class_names = names

    def on_device(self, device) -> "Predictor":
        """A copy of this predictor serving a copy of its weights on
        `device`, in one part: what a bundle's graph set for that device
        type is held to (export.py's --check)."""
        out = copy.copy(self)
        out.device = torch.device(device)
        out._params = copy.deepcopy(self._params).to(out.device)
        out.data_parallel = False
        out._split = LocalSplit(out._params, [out.device])
        return out

    @classmethod
    def from_config(cls, config_path: str, class_names: Sequence[str],
                    **kwargs) -> "Predictor":
        """Build from an experiment config file (the CLIs' --params)."""
        return cls(load_params(config_path), class_names, **kwargs)


def device_step(params, cfg, spec: RasterSpec, pp: ClipPreprocess,
                windows: torch.Tensor, valid: torch.Tensor,
                view_src: Optional[torch.Tensor] = None
                ) -> Dict[str, torch.Tensor]:
    """The device step: rasterize -> preprocess -> classifier, packed when
    `view_src` is given, padded otherwise. A pure function of the weights
    `params`, so export.py freezes it with the weights as inputs."""
    x = rasterize_for_clip(spec, pp, windows)
    if view_src is not None:
        return classifier_forward_packed(params, cfg, x, view_src, valid)
    return classifier_forward(params, cfg, x, valid)


def embed_features(out: Dict[str, torch.Tensor],
                   valid: torch.Tensor) -> torch.Tensor:
    """A padded step's output -> [B, C] embeddings: the per-view features at
    the text-matmul point, normalized (ZS features arrive raw), zeroed where
    the view is padding, averaged over the valid views, re-normalized."""
    f = normalize(out["view_feats"]) * valid[..., None]
    n = valid.sum(-1, keepdim=True).clamp(min=1)
    return normalize(f.sum(1) / n)


class StreamSession:
    """Online sliding-window classification over a live event stream.

    `append` events as they arrive (any chunking), ask for a rolling
    `predict` at any time. The session keeps the most recent `horizon`
    events (default view budget x window, the events the eval path can see
    per sample) in a ring buffer, and prediction routes the buffer through
    the unchanged Predictor path, so a session's answer over its buffer
    equals `Predictor.predict([buffer])`. append/predict/reset are
    thread-safe; one session is one logical stream (one per sensor).
    """

    def __init__(self, predictor: Predictor, horizon: Optional[int] = None):
        self._pred = predictor
        self._horizon = int(horizon if horizon is not None
                            else predictor.views * predictor.window)
        if self._horizon < predictor.window:
            raise ValueError(
                f"horizon {self._horizon} is smaller than one window "
                f"({predictor.window} events) — no prediction could ever "
                "see a full view"
            )
        self._chunks: "collections.deque[np.ndarray]" = collections.deque()
        self._n = 0
        self._lock = threading.Lock()

    @property
    def n_events(self) -> int:
        return self._n

    @property
    def horizon(self) -> int:
        return self._horizon

    def append(self, events: np.ndarray) -> int:
        """Buffer a chunk of [n, 4] x/y/t/p events (chronological across
        appends); returns the buffered event count after trimming to the
        horizon. Empty chunks are fine (a quiet sensor interval)."""
        events = np.asarray(events, dtype=np.float32)
        if events.size == 0:
            # a quiet interval arrives as [] / [[]] from JSON decoders
            events = events.reshape(0, 4)
        if events.ndim != 2 or events.shape[1] != 4:
            raise ValueError(
                f"expected [n, 4] x/y/t/p events, got {events.shape}"
            )
        with self._lock:
            if events.shape[0]:
                # own copy: the caller may reuse its buffer
                self._chunks.append(np.array(events, copy=True))
                self._n += len(events)
                while self._n > self._horizon:
                    extra = self._n - self._horizon
                    head = self._chunks[0]
                    if len(head) <= extra:
                        self._chunks.popleft()
                        self._n -= len(head)
                    else:
                        self._chunks[0] = head[extra:]
                        self._n -= extra
            return self._n

    def events(self) -> np.ndarray:
        """Snapshot of the buffered (most recent <= horizon) events."""
        with self._lock:
            if not self._n:
                return np.empty((0, 4), np.float32)
            return np.concatenate(self._chunks)

    def predict(self, top_k: int = 1, predict_fn=None) -> Dict[str, Any]:
        """Rolling prediction over the buffered events: the single-stream
        slice of Predictor.predict's dict plus 'n_events'.
        `predict_fn(streams, top_k=...)` replaces the device entry: the HTTP
        server passes its fused or locked path, so its session routes share
        this response assembly."""
        snap = self.events()
        if not len(snap):
            raise ValueError(
                "empty session — append events before predict() (an idle "
                "sensor window has no defined prediction)"
            )
        fn = predict_fn if predict_fn is not None else self._pred.predict
        out = fn([snap], top_k=top_k)
        return {
            "label": int(out["label"][0]),
            "name": out["names"][0],
            "probs": out["probs"][0],
            "topk": out["topk"][0],
            "n_events": int(len(snap)),
        }

    def reset(self) -> None:
        """Drop the buffer (e.g. on scene change); the session stays usable."""
        with self._lock:
            self._chunks.clear()
            self._n = 0


def load_event_file(path: str) -> np.ndarray:
    """One raw sensor dump -> [n, 4] float32 events.

    .npy = a plain array (N-Caltech/N-Cars layout); .npz = the structured
    N-ImageNet layout (data.datasets.load_event_npz) or a plain `np.savez`
    dump holding a single [n, 4] array under any key."""
    if path.endswith(".npz"):
        with np.load(path) as z:
            keys = list(z.files)
            if "event_data" not in keys:
                if (len(keys) == 1 and z[keys[0]].ndim == 2
                        and z[keys[0]].shape[1] == 4):
                    return z[keys[0]].astype(np.float32)
                raise ValueError(
                    f"unrecognized npz layout (keys {keys}): expected the "
                    "N-ImageNet 'event_data' structured array or a single "
                    "[n, 4] array"
                )
        return load_event_npz(path)  # already float32
    return np.load(path).astype(np.float32)


def resolve_class_names(params, classes_file: str = "",
                        data_root: str = "") -> List[str]:
    """Class names for the prompt head, without a dataset tree when a file
    is given: one name per line in `classes_file`, else the class list of
    the config's dataset rooted at `data_root` (the eval CLI's folder
    listing and rename tables). Port of eventclip_tpu/server.py's."""
    if classes_file:
        with open(classes_file) as f:
            names = [ln.strip() for ln in f if ln.strip()]
        if not names:
            raise ValueError(f"no class names in {classes_file}")
        return names
    if data_root:
        params.data_root = data_root
        return list(build_dataset(params, val_only=True).classes)
    raise ValueError("pass --classes <file> or --data_root <dataset dir> "
                     "to define the label space")


def main(argv=None) -> None:
    """Offline batch inference: classify a folder/glob of raw event dumps
    without a dataset tree, checkpoint sweep, or HTTP server.

        python -m eventclip_tpu_torch.serve --params <cfg> \\
            --classes names.txt --inputs 'dumps/**/*.npy' \\
            --out predictions.jsonl [--weight ckpt] [--int8] [--cpu] ...

    Writes one JSON line per input: {"path", "label", "name", "topk",
    "topk_names"} (+"probs" with --probs), in input order; with
    --embed_out, one npz (paths [N], embeddings [N, C]) instead. Runs on
    the card unless --cpu is given.
    """
    import argparse
    import glob as globlib
    import json
    import sys

    ap = argparse.ArgumentParser(
        description="Offline batch inference over a glob of event dumps.")
    ap.add_argument("--params", default="")
    ap.add_argument("--from_export", default="",
                    help="classify with a frozen bundle (python -m "
                    "eventclip_tpu_torch.export) instead of building the "
                    "model; model flags are baked into the bundle and "
                    "rejected")
    ap.add_argument("--inputs", required=True,
                    help="glob of .npy/.npz event dumps (quote it)")
    ap.add_argument("--out", default="-",
                    help="output JSONL path (default: stdout)")
    ap.add_argument("--weight", default="")
    ap.add_argument("--classes", default="")
    ap.add_argument("--data_root", default="")
    ap.add_argument("--clip_ckpt", default="")
    ap.add_argument("--batch_size", type=int, default=32)
    ap.add_argument("--top_k", type=int, default=5)
    ap.add_argument("--probs", action="store_true",
                    help="include the full probability row per input")
    ap.add_argument("--int8", action="store_true")
    ap.add_argument("--prune_tokens", type=int, default=0)
    ap.add_argument("--data_parallel", action="store_true",
                    help="replicate the model on every visible card and "
                    "split each batch over them")
    ap.add_argument("--tta", action="store_true",
                    help="4-variant event TTA (4x compute, averaged probs)")
    ap.add_argument("--embed_out", default="",
                    help="switch to embedding extraction: write one npz "
                         "(paths [N], embeddings [N, C] f32 L2-normalized) "
                         "instead of prediction JSONL")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (debug/smoke runs)")
    args = ap.parse_args(argv)

    if bool(args.params) == bool(args.from_export):
        ap.error("pass exactly one of --params or --from_export")
    if args.from_export:
        # every model decision is frozen inside the bundle; a flag that
        # silently did nothing would be a misconfiguration
        baked = {"--weight": args.weight, "--classes": args.classes,
                 "--data_root": args.data_root,
                 "--clip_ckpt": args.clip_ckpt, "--int8": args.int8,
                 "--prune_tokens": args.prune_tokens,
                 "--data_parallel": args.data_parallel, "--tta": args.tta,
                 "--embed_out": args.embed_out, "--smoke": args.smoke}
        offending = [k for k, v in baked.items() if v]
        if args.batch_size != ap.get_default("batch_size"):
            offending.append("--batch_size")
        if offending:
            ap.error(f"{' '.join(offending)}: baked into the bundle at "
                     "export time — re-export to change them")
    paths = sorted(globlib.glob(args.inputs, recursive=True))
    if not paths:
        raise SystemExit(f"no files match {args.inputs!r}")
    device = "cpu" if args.cpu else "cuda"
    if args.from_export:
        from .export import ExportedPredictor

        pred = ExportedPredictor(args.from_export, device=device)
        names = pred.class_names
    else:
        params = load_params(args.params)
        names = resolve_class_names(params, args.classes, args.data_root)
        pred = Predictor(params, names, weight=args.weight,
                         clip_ckpt=args.clip_ckpt or None, smoke=args.smoke,
                         int8=args.int8, prune_tokens=args.prune_tokens,
                         batch_size=args.batch_size, tta=args.tta,
                         embed=bool(args.embed_out), device=device,
                         data_parallel=args.data_parallel)

    def load(p):
        # a bad file mid-glob must name itself
        try:
            return load_event_file(p)
        except Exception as err:
            raise SystemExit(f"error: {p}: {err}") from None

    if args.embed_out:
        feats = []
        for i in range(0, len(paths), pred.batch_size):
            chunk = paths[i:i + pred.batch_size]
            feats.append(pred.embed([load(p) for p in chunk]))
            print(f"{min(i + pred.batch_size, len(paths))}/{len(paths)}",
                  file=sys.stderr, flush=True)
        np.savez(args.embed_out, paths=np.array(paths),
                 embeddings=np.concatenate(feats))
        print(f"wrote {len(paths)} embeddings -> {args.embed_out}",
              file=sys.stderr, flush=True)
        return

    sink = sys.stdout if args.out == "-" else open(args.out, "w")
    try:
        # chunk at the batch size so memory stays flat on huge globs
        for i in range(0, len(paths), pred.batch_size):
            chunk = paths[i:i + pred.batch_size]
            out = pred.predict([load(p) for p in chunk], top_k=args.top_k)
            for j, p in enumerate(chunk):
                rec = {
                    "path": p,
                    "label": int(out["label"][j]),
                    "name": out["names"][j],
                    "topk": out["topk"][j].tolist(),
                    "topk_names": [names[t] for t in out["topk"][j]],
                }
                if args.probs:
                    rec["probs"] = out["probs"][j].tolist()
                sink.write(json.dumps(rec) + "\n")
            sink.flush()
            print(f"{min(i + pred.batch_size, len(paths))}/{len(paths)}",
                  file=sys.stderr, flush=True)
    finally:
        if sink is not sys.stdout:
            sink.close()


if __name__ == "__main__":
    main()
