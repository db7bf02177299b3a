"""The trainer, and the parameter resolution shared by the entry points.

Port of eventclip_tpu/engine/trainer.py on one device: `EventCLIPTrainer`
(the reference's nerv BaseMethod / EventCLIPMethod for the ZS, FS and FT
heads: per-step optimizer with warmup-cosine schedules and FTCLIP's two LR
groups, on-device RandAugment when the train set asks for it, a sanity-check
validation before training, eval every `eval_interval` epochs, trainable
checkpoints every `save_interval` epochs with `val/probs_acc` best
tracking, resume from a full-state file), plus `resolve_clip_params`
(a released OpenAI `.pt`, a converted `.npz`, or the smoke/debug random
init), `snapshot_logit_scale` and `build_text_features` (prompts through
the BPE tokenizer). The multi-host, ZeRO-1, preemption-signal, profiler
and visualization parts of the JAX trainer are ROADMAP item 7.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import math
import os
import time
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from ..data.loader import (PrefetchLoader, device_prefetch,
                           eval_pack_buckets, pack_view_batch)
from ..models.classifier import (DEFAULT_PROMPT, ClassifierConfig,
                                 build_classifier_config,
                                 class_text_features, init_classifier_params,
                                 normalize)
from ..models.clip.config import clip_arch_config
from ..models.clip.convert import (clip_from_jax, flatten_tree, jax_shapes,
                                   load_clip_checkpoint)
from ..models.clip.convert_method import unflatten
from ..models.clip.model import CLIP, init_clip_params
from ..models.clip.tokenizer import SimpleTokenizer
from ..ops.preprocess import ClipPreprocess
from ..utils.meters import AverageMeter
from .checkpoint import CheckpointManager, load_checkpoint
from .optim import OptimConfig, Optimizer
from .train import make_eval_step, make_train_step


def _checked_tree(flat: Dict[str, np.ndarray], clip_cfg, ckpt: str):
    """The CLIP tree of `clip_cfg` from {JAX path: array}: every leaf the
    towers need, each of their shape; leaves the towers lack are ignored."""
    want = jax_shapes(CLIP(clip_cfg, device="meta").named_parameters())
    missing = [k for k in want if k not in flat]
    if missing:
        # a partly matching file must not leave random leaves in towers
        # treated as pretrained
        raise ValueError(
            f"{ckpt} is missing {len(missing)} parameter(s) the "
            f"{clip_cfg.name!r} towers need (e.g. {missing[:3]}); loading "
            "it would silently mix random weights into towers treated as "
            "pretrained")
    for key, shape in want.items():
        if tuple(flat[key].shape) != shape:
            raise ValueError(
                f"{key}: ckpt {tuple(flat[key].shape)} vs model {shape}: is "
                f"{ckpt} converted for {clip_cfg.name!r}?")
    return unflatten({k: flat[k] for k in want})


def resolve_clip_params(params_cfg, clip_cfg, generator: torch.Generator,
                        clip_ckpt: Optional[str] = None, smoke: bool = False,
                        device="cuda"):
    """(CLIP towers, pretrained): released weights from `clip_ckpt` (or the
    config's `clip_ckpt`), an OpenAI `.pt` or a converted `.npz` keyed by
    the JAX tree paths; else random init in smoke/debug mode.

    Running without a checkpoint is an error unless `smoke` is set or the
    arch is a debug tower (no released weights), because random towers
    give garbage accuracies without otherwise failing."""
    ckpt = clip_ckpt or params_cfg.get("clip_ckpt", None)
    if ckpt and not os.path.exists(ckpt):
        raise FileNotFoundError(f"CLIP checkpoint not found: {ckpt}")
    if ckpt:
        if ckpt.endswith(".npz"):
            flat, _ = load_checkpoint(ckpt)
        else:
            flat = flatten_tree(load_clip_checkpoint(ckpt)[0])
        tree = _checked_tree(flat, clip_cfg, ckpt)
        return clip_from_jax(tree, clip_cfg, device), True
    if not (smoke or clip_cfg.debug):
        raise FileNotFoundError(
            f"No CLIP checkpoint for {clip_cfg.name!r}. Real runs need the "
            "released OpenAI weights (the reference downloads them via "
            "clip.load, reference train.py:26):\n"
            "  - pass --clip_ckpt /path/to/checkpoint.pt (torch archive), or"
            "\n  - a converted .npz (scripts/convert_clip.py),\n"
            "  - or set the CLIP_CKPT environment variable.\n"
            "Pass --smoke to run with RANDOM weights (throughput/pipeline "
            "testing only; every reported accuracy will be garbage).")
    print("WARNING: smoke mode - RANDOM CLIP weights; accuracies are garbage")
    return init_clip_params(clip_cfg, generator, device=device), False


@torch.no_grad()
def copy_clip(clip_params, cfg, device) -> CLIP:
    """A port `CLIP` module on `device` from a port module (copied, so the
    caller's towers never change under it) or from the JAX package's
    parameter tree as numpy arrays (models/clip/convert.py)."""
    if isinstance(clip_params, CLIP):
        clip = CLIP(cfg, device="meta").to_empty(device=device)
        clip.load_state_dict(clip_params.state_dict())
        return clip
    return clip_from_jax(clip_params, cfg, device)


def snapshot_logit_scale(cls_cfg, clip: CLIP, pretrained: bool):
    """Snapshot exp(learned tau) from the checkpoint into the classifier
    config (reference models/clip_cls.py:44); random-init runs keep the
    config default of 100.0."""
    if not pretrained:
        return cls_cfg
    return dataclasses.replace(
        cls_cfg, logit_scale=math.exp(float(clip.logit_scale.detach())))


def build_text_features(clip: CLIP, clip_cfg, class_names: Sequence[str],
                        prompt: str, pretrained: bool) -> torch.Tensor:
    """L2-normalized prompted class text features [n_cls, C] through the
    BPE tokenizer and the text tower. Without the vocab, random features
    from a seeded generator stand in, for towers that are not pretrained
    only: with real weights they would silently give garbage zero-shot
    numbers. EVENTCLIP_ALLOW_RANDOM_TEXT=1 lifts that refusal; it is sound
    only where the text features are overwritten afterwards (prompt-tuned
    checkpoints carry their own)."""
    try:
        tokenizer = SimpleTokenizer()
    except (FileNotFoundError, OSError) as e:
        hatch = os.environ.get("EVENTCLIP_ALLOW_RANDOM_TEXT") == "1"
        if pretrained and not hatch:
            raise FileNotFoundError(
                "BPE vocab asset missing; drop bpe_simple_vocab_16e6.txt.gz "
                "into eventclip_tpu_torch/assets/ or set EVENTCLIP_BPE_PATH "
                f"to tokenize prompts with real CLIP weights. ({e})") from e
        print("WARNING: BPE vocab asset missing - random text features "
              "(smoke mode)" + (" [EVENTCLIP_ALLOW_RANDOM_TEXT]"
                                if hatch else ""))
        gen = torch.Generator(device="cpu").manual_seed(1234)
        feats = torch.randn((len(class_names), clip_cfg.embed_dim),
                            generator=gen)
        return normalize(feats).to(clip.logit_scale.device)
    with torch.inference_mode():
        return class_text_features(clip, class_names, prompt, tokenizer)


def _log_jsonl(path: Optional[str], record: Dict[str, Any]) -> None:
    if path:
        with open(path, "a") as f:
            f.write(json.dumps(record) + "\n")


def sync_device(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class EventCLIPTrainer:
    """Train and evaluate one classifier on one device.

    params: the experiment config (utils.config.Params). train_set /
    val_set: `data.event_windows.EventWindowDataset`s. clip_ckpt: released
    CLIP weights (`.pt` or converted `.npz`; the config's `clip_ckpt` when
    omitted). clip_params / text_feats: optional towers (a port `CLIP` or a
    JAX tree, copied, treated as not pretrained) and [n_cls, C] class
    features; without towers or a checkpoint, random towers (smoke/debug
    only); without features, the prompts through the tokenizer (random
    ones for random towers without a vocab). Everything runs on `device`
    ("cuda" unless the caller passes "cpu").

    Each train step ends in a device synchronize, so `step_times` (per
    step of the last epoch: seconds spent waiting for the host loader and
    the batch's placement, and seconds of the step itself) are device
    times; the metrics stay on the device until the epoch ends.
    """

    def __init__(
        self,
        params,
        train_set,
        val_set,
        ckpt_dir: str,
        clip_ckpt: Optional[str] = None,
        clip_params=None,
        text_feats=None,
        log_file: Optional[str] = None,
        seed: int = 0,
        smoke: bool = False,
        device="cuda",
    ):
        self.params = params
        self.train_set = train_set
        self.val_set = val_set
        self.log_file = log_file
        self.device = torch.device(device)

        self.clip_cfg = clip_arch_config(params.clip_dict["arch"])
        # bf16 activations by default; bf16=False runs f32 end to end
        dtype = (torch.bfloat16 if bool(params.get("bf16", True))
                 else torch.float32)
        self.cls_cfg: ClassifierConfig = build_classifier_config(
            params, self.clip_cfg, dtype=dtype)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        if clip_params is None:
            clip, self.pretrained = resolve_clip_params(
                params, self.clip_cfg, gen, clip_ckpt, smoke=smoke,
                device=self.device)
        else:
            clip, self.pretrained = copy_clip(
                clip_params, self.clip_cfg, self.device), False
        self.cls_cfg = snapshot_logit_scale(self.cls_cfg, clip,
                                            self.pretrained)
        if text_feats is None:
            text_feats = build_text_features(
                clip, self.clip_cfg, train_set.classes,
                params.clip_dict.get("prompt", DEFAULT_PROMPT),
                self.pretrained)
        self.model_params = init_classifier_params(
            self.cls_cfg, gen, clip=clip, text_feats=text_feats,
            device=self.device)

        # gradient accumulation: one optimizer update per accum_steps
        # sequential microbatches, keeping the config's global batch
        self.accum = max(int(params.get("accum_steps", 1)), 1)
        self.global_batch = int(params.train_batch_size)
        if self.global_batch % self.accum:
            adjusted = max(self.accum,
                           self.global_batch - self.global_batch % self.accum)
            print(f"WARNING: train_batch_size={self.global_batch} is not "
                  f"divisible by accum_steps={self.accum}; training at "
                  f"batch {adjusted} instead", flush=True)
            self.global_batch = adjusted
        workers = int(params.get("num_workers", 8))
        self.train_loader = PrefetchLoader(
            train_set, self.global_batch, shuffle=True, drop_last=True,
            num_workers=workers, seed=seed)
        val_bs = int(params.get("val_batch_size", self.global_batch))
        self.val_loader = PrefetchLoader(val_set, val_bs, pad_last=True,
                                         num_workers=workers)
        # packed eval: only real views are rasterized and encoded
        self._eval_buckets = eval_pack_buckets(val_bs, val_set.max_imgs, 1)

        steps_per_epoch = max(len(self.train_loader), 1)
        self.opt_cfg = OptimConfig(
            optimizer=params.get("optimizer", "Adam"),
            lr=float(params.lr),
            clip_lr=float(params.get("clip_lr", params.lr)),
            weight_decay=float(params.get("weight_decay", 0.0)),
            total_steps=int(params.get("max_epochs", 1)) * steps_per_epoch,
            warmup_steps_pct=float(params.get("warmup_steps_pct", 0.05)),
            grad_clip=float(params.get("grad_clip", -1)),
        )
        self.optimizer = Optimizer(self.cls_cfg, self.opt_cfg,
                                         self.model_params)

        spec = train_set.raster_spec()
        self.pipeline = (spec, ClipPreprocess(
            in_height=spec.height, in_width=spec.width,
            image_size=self.clip_cfg.vision.image_size))
        self.train_step = make_train_step(
            self.cls_cfg, self.model_params, self.optimizer,
            loss_weights={"ce_loss": float(params.get("ce_loss_w", 1.0))},
            pipeline=self.pipeline,
            augment=bool(getattr(train_set, "augment", False)),
            accum_steps=self.accum, seed=seed)
        self.eval_step = make_eval_step(
            self.cls_cfg, self.model_params,
            top5=params.dataset == "n_imagenet", pipeline=self.pipeline)

        self.ckpt = CheckpointManager(ckpt_dir, self.cls_cfg)
        self.ckpt_dir = ckpt_dir
        self.epoch = 0
        self.step_times = []

    def device_batch(self, batch: Dict[str, np.ndarray]
                      ) -> Dict[str, torch.Tensor]:
        keep = ("windows", "img", "valid_mask", "label", "sample_mask",
                "view_src")
        out = {k: torch.from_numpy(np.ascontiguousarray(v)).to(
                   self.device, non_blocking=True)
               for k, v in batch.items() if k in keep}
        out["label"] = out["label"].long()
        return out

    def train_epoch(self, epoch: int) -> Dict[str, float]:
        """One pass over the train loader; returns the epoch's stats."""
        self.epoch = epoch
        t0 = time.perf_counter()
        self.step_times = []
        metric_hist = []
        batches = device_prefetch(self.train_loader.epoch(epoch),
                                  self.device_batch)
        while True:
            t_wait = time.perf_counter()
            batch = next(batches, None)
            if batch is None:
                break
            t_step = time.perf_counter()
            metric_hist.append(self.train_step(batch))
            sync_device(self.device)
            self.step_times.append((t_step - t_wait,
                                    time.perf_counter() - t_step))
        meters: Dict[str, AverageMeter] = {}
        for metrics in metric_hist:
            for k, v in metrics.items():
                meters.setdefault(k, AverageMeter()).update(float(v))
        dt = time.perf_counter() - t0
        stats = {k: m.avg for k, m in meters.items()}
        stats.update(
            epoch=epoch, steps=self.optimizer.count,
            sec_per_epoch=round(dt, 2),
            samples_per_sec=round(
                self.global_batch * max(len(metric_hist), 1) / dt, 2))
        print(f"[train] {stats}", flush=True)
        _log_jsonl(self.log_file, {"split": "train", **stats})
        return stats

    def save(self, epoch: int, val_stats=None) -> None:
        """Trainable checkpoint (and best tracking) + resume state."""
        self.ckpt.save(self.model_params, self.optimizer.count, val_stats)
        self.ckpt.save_resume_state(self.model_params, self.optimizer,
                                    epoch + 1)

    def fit(self, resume_from: str = "", san_check_val_step: int = 2) -> None:
        start_epoch = 0
        restored = self.ckpt.load_resume_state(self.model_params,
                                               self.optimizer)
        if restored is not None:
            start_epoch = restored
            print(f"Resumed full state from epoch {start_epoch}")
        elif resume_from:
            load_checkpoint(resume_from, target=self.model_params)
            print(f"Loaded weights from {resume_from}")

        if san_check_val_step:
            self.evaluate(max_steps=san_check_val_step)

        max_epochs = int(self.params.get("max_epochs", 1))
        eval_interval = int(self.params.get("eval_interval", 5))
        save_interval = max(int(self.params.get("save_interval", 1)), 1)
        for epoch in range(start_epoch, max_epochs):
            self.train_epoch(epoch)
            last = epoch + 1 == max_epochs
            val_stats = None
            if (epoch + 1) % eval_interval == 0 or last:
                val_stats = self.evaluate()
            if (epoch + 1) % save_interval == 0 or last:
                self.save(epoch, val_stats)

    def evaluate(self, max_steps: Optional[int] = None) -> Dict[str, float]:
        """Packed eval over the val loader (or its first `max_steps`
        batches); counters stay on the device until the end."""
        host_iter = (itertools.islice(self.val_loader, max_steps)
                     if max_steps is not None else self.val_loader)

        def prep(batch):
            if self._eval_buckets and "windows" in batch:
                batch = pack_view_batch(batch, self._eval_buckets)
            return self.device_batch(batch)

        results = [self.eval_step(b) for b in device_prefetch(host_iter, prep)]
        sums: Dict[str, float] = {}
        for res in results:
            for k, v in res.items():
                sums[k] = sums.get(k, 0.0) + float(v)
        n = max(sums.pop("n", 1.0), 1.0)
        stats = {
            "probs_acc": sums.pop("probs_correct", 0.0) / n,
            "logits_acc": sums.pop("logits_correct", 0.0) / n,
            "ce_loss": sums.pop("ce_loss_sum", 0.0) / n,
        }
        for k, v in sums.items():
            stats[k.replace("_correct5", "_acc5")] = v / n
        stats["n"] = n
        print(f"[val]   epoch {self.epoch}: {stats}", flush=True)
        _log_jsonl(self.log_file, {"split": "val", "epoch": self.epoch,
                                   **stats})
        return stats
