"""The trainer, and the parameter resolution shared by the entry points.

Port of eventclip_tpu/engine/trainer.py: `EventCLIPTrainer`
(the reference's nerv BaseMethod / EventCLIPMethod for the ZS, FS and FT
heads: per-step optimizer with warmup-cosine schedules and FTCLIP's two LR
groups, on-device RandAugment when the train set asks for it, a sanity-check
validation before training, eval every `eval_interval` epochs, trainable
checkpoints every `save_interval` epochs with `val/probs_acc` best
tracking, resume from a full-state file, a stable run id, graceful
preemption on SIGTERM / SIGUSR1, a profiler trace of `profile_steps`
steps, validation GIFs), data-parallel over the ranks of a process group
(parallel/distributed.py: each rank loads its shard of every global batch,
rank 0 alone writes files), with `n_model` > 1 tensor-parallel over
groups of that many ranks and with `params.zero1` keeping each data
rank's slice of the Adam moments only (parallel/sharding.py), plus
`resolve_clip_params` (a released OpenAI `.pt`, a converted `.npz`, or
the smoke/debug random init), `snapshot_logit_scale` and
`build_text_features` (prompts through the BPE tokenizer).
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

from ..data.loader import (PrefetchLoader, adaptive_prefetch,
                           device_prefetch, eval_pack_buckets,
                           pack_view_batch)
from ..models.classifier import (DEFAULT_PROMPT, ClassifierConfig,
                                 build_classifier_config,
                                 class_text_features, classifier_forward,
                                 init_classifier_params, normalize)
from ..models.clip.config import clip_arch_config
from ..models.clip.convert import (clip_from_jax, flatten_tree, jax_shapes,
                                   load_clip_checkpoint)
from ..models.clip.convert_method import unflatten
from ..models.clip.model import CLIP, init_clip_params
from ..models.clip.tokenizer import SimpleTokenizer
from ..ops.preprocess import ClipPreprocess
from ..ops.rasterize import rasterize_for_clip
from ..parallel.distributed import (all_reduce_sum, any_process_flag,
                                    host_shard_info, process_count,
                                    process_index)
from ..parallel.sharding import make_mesh, shard_params
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
    """Train and evaluate one classifier on one device, or data-parallel
    over the ranks of a process group joined before it is built (each
    rank on its own `device`). `n_model` > 1 splits the towers' blocks
    over groups of that many ranks (rank = data_index · n_model +
    model_index; the world must divide), and the config's `zero1` keeps
    the optimizer moments of each data rank's slices only.

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

    Config keys beyond the reference's: `profile_steps` (a torch.profiler
    trace of that many steps of the first epoch under
    `<ckpt_dir>/profile/`, rank 0), `visualize` (default True) and
    `n_samples` (GIFs and captions of that many val items under
    `<ckpt_dir>/viz/epoch_<k>/` after each full eval; one process only).
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
        n_model: int = 1,
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

        # the layout of the ranks: data-parallel over all of them unless
        # model sharding is asked (a collective: every rank builds it)
        self.mesh = make_mesh(n_model)
        self.n_data, self.n_model = self.mesh.n_data, self.mesh.n_model
        self.tp = self.mesh if self.n_model > 1 else None

        # gradient accumulation: one optimizer update per accum_steps
        # sequential microbatches, keeping the config's global batch;
        # every data rank's microbatch is a whole share of the global one
        self.accum = max(int(params.get("accum_steps", 1)), 1)
        shard_index, num_shards = host_shard_info(self.tp)
        self.global_batch = int(params.train_batch_size)
        divisor = num_shards * self.accum
        if self.global_batch % divisor:
            adjusted = max(divisor,
                           self.global_batch - self.global_batch % divisor)
            print(f"WARNING: train_batch_size={self.global_batch} is not "
                  f"divisible by data_devices*accum={divisor}; training at "
                  f"global batch {adjusted} instead", flush=True)
            self.global_batch = adjusted
        self.is_main = process_index() == 0
        if self.is_main:
            print(f"mesh: devices={process_count()} data={self.n_data} "
                  f"model={self.n_model} "
                  f"host_shard={shard_index}/{num_shards}", flush=True)
        if num_shards > 1 and self.is_main:
            print(f"data parallel: {num_shards} ranks, each loading "
                  f"{self.global_batch // num_shards} of every global "
                  f"batch of {self.global_batch}", flush=True)
        workers = int(params.get("num_workers", 8))
        self.train_loader = PrefetchLoader(
            train_set, self.global_batch, shuffle=True, drop_last=True,
            num_workers=workers, seed=seed, shard_index=shard_index,
            num_shards=num_shards)
        val_bs = int(params.get("val_batch_size", self.global_batch))
        val_bs = max(val_bs - val_bs % num_shards, num_shards)
        self.val_loader = PrefetchLoader(
            val_set, val_bs, pad_last=True, num_workers=workers,
            shard_index=shard_index, num_shards=num_shards)
        # packed eval: only real views are rasterized and encoded
        self._eval_buckets = eval_pack_buckets(
            val_bs, val_set.max_imgs, num_shards, num_shards)
        # the prefetch depth, measured in the first epoch (adaptive_prefetch)
        self._prefetch_choice: dict = {}

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
        # each leaf cut once to this rank's model shard, before the
        # optimizer sees it; ZeRO-1 needs more than one data rank
        shard_params(self.model_params, self.tp)
        self.zero1 = bool(params.get("zero1", False)) and self.n_data > 1
        self.optimizer = Optimizer(self.cls_cfg, self.opt_cfg,
                                   self.model_params, zero1=self.zero1)

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
            top5=params.dataset == "n_imagenet", pipeline=self.pipeline,
            shard_index=shard_index, num_shards=num_shards)

        # every rank runs the same compute, rank 0 alone touches shared
        # files: checkpoints, resume state, metrics, run id, traces, GIFs
        self.ckpt = CheckpointManager(ckpt_dir, self.cls_cfg)
        self.ckpt_dir = ckpt_dir
        self.run_id = self._resolve_run_id(ckpt_dir, write=self.is_main)
        if not self.is_main:
            self.log_file = None
        self.epoch = 0
        self.step_times = []
        self.profile_steps = (int(params.get("profile_steps", 0))
                              if self.is_main else 0)
        self.visualize = bool(params.get("visualize", True))
        # views through the viz forward at the last eval (probs, inputs)
        self.viz_forwards = (0, 0)
        self.profile_trace = None

    @staticmethod
    def _resolve_run_id(ckpt_dir: str, write: bool = True) -> str:
        """Stable experiment identity that survives preemption / resume:
        minted once a ckpt_dir (`<exp>-<SLURM_JOB_ID | JOB_ID |
        pid-time>`) and kept in `run_id.txt`, so a resumed job appends to
        the same curve. Ranks other than 0 pass write=False."""
        rid_path = os.path.join(ckpt_dir, "run_id.txt")
        if os.path.exists(rid_path):
            with open(rid_path) as f:
                rid = f.read().strip()
            if rid:
                return rid
        exp = os.path.basename(os.path.normpath(ckpt_dir)) or "run"
        job = (os.environ.get("SLURM_JOB_ID") or os.environ.get("JOB_ID")
               or f"{os.getpid()}-{int(time.time())}")
        rid = f"{exp}-{job}"
        if write:
            tmp = rid_path + ".tmp"
            with open(tmp, "w") as f:
                f.write(rid + "\n")
            os.replace(tmp, rid_path)
        return rid

    def device_batch(self, batch: Dict[str, np.ndarray]
                      ) -> Dict[str, torch.Tensor]:
        keep = ("windows", "img", "valid_mask", "label", "sample_mask",
                "view_src")
        out = {k: torch.from_numpy(np.ascontiguousarray(v)).to(
                   self.device, non_blocking=True)
               for k, v in batch.items() if k in keep}
        out["label"] = out["label"].long()
        return out

    def _start_profile(self):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.start()
        return prof

    def _stop_profile(self, prof, epoch: int, first: int, n: int) -> None:
        """Stop the trace and write it as Chrome JSON under
        <ckpt_dir>/profile/; `profile_trace` records the file, its size
        and the seconds the write took."""
        sync_device(self.device)
        prof.stop()
        out = os.path.join(self.ckpt_dir, "profile")
        os.makedirs(out, exist_ok=True)
        path = os.path.join(out, f"trace_epoch{epoch}_steps{first}-"
                            f"{first + n - 1}.json")
        t0 = time.perf_counter()
        prof.export_chrome_trace(path)
        self.profile_trace = dict(path=path, bytes=os.path.getsize(path),
                                  write_s=time.perf_counter() - t0, steps=n)
        print(f"[profile] {n} step(s) traced to {path}", flush=True)

    def train_epoch(self, epoch: int) -> Dict[str, float]:
        """One pass over the train loader; returns the epoch's stats. With
        `profile_steps`, epoch 0 traces that many steps after a warm-up
        of up to 2 (fewer when the epoch is short)."""
        self.epoch = epoch
        t0 = time.perf_counter()
        self.step_times = []
        metric_hist = []
        warmup = min(2, max(len(self.train_loader) - self.profile_steps, 0))
        trace = self.profile_steps > 0 and epoch == 0
        prof = None
        # the prefetch depth is measured in the first epoch, then reused
        batches = adaptive_prefetch(self.train_loader.epoch(epoch),
                                    self.device_batch,
                                    choice=self._prefetch_choice)
        while True:
            t_wait = time.perf_counter()
            batch = next(batches, None)
            if batch is None:
                break
            if trace and prof is None and len(metric_hist) == warmup:
                prof = self._start_profile()
            t_step = time.perf_counter()
            metric_hist.append(self.train_step(batch))
            sync_device(self.device)
            self.step_times.append((t_step - t_wait,
                                    time.perf_counter() - t_step))
            if prof is not None and trace and \
                    len(metric_hist) == warmup + self.profile_steps:
                self._stop_profile(prof, epoch, warmup, self.profile_steps)
                trace = False
        if prof is not None and trace:
            self._stop_profile(prof, epoch, warmup,
                               len(metric_hist) - warmup)
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
        if self.is_main:
            print(f"[train] {stats}", flush=True)
        _log_jsonl(self.log_file,
                   {"run_id": self.run_id, "split": "train", **stats})
        return stats

    def save(self, epoch: int, val_stats=None) -> None:
        """Trainable checkpoint (and best tracking) + resume state; every
        rank calls it, rank 0 writes."""
        self.ckpt.save(self.model_params, self.optimizer.count, val_stats)
        self.ckpt.save_resume_state(self.model_params, self.optimizer,
                                    epoch + 1)

    def _on_preempt_signal(self, signum, frame) -> None:
        self._preempt_signum = signum
        if self.is_main:
            print(f"[preempt] caught signal {signum}; will checkpoint at "
                  "the epoch boundary and exit", flush=True)

    def _reraise_preempt_signal(self) -> None:
        """Die by the original signal so schedulers / watchdogs resubmit.
        EVENTCLIP_PREEMPT_EXIT=0 returns instead (in-process tests), and
        so does a rank that caught no signal itself."""
        import signal

        if os.environ.get("EVENTCLIP_PREEMPT_EXIT", "1") == "0" or \
                self._preempt_signum is None:
            return
        signal.signal(self._preempt_signum, signal.SIG_DFL)
        os.kill(os.getpid(), self._preempt_signum)

    def fit(self, resume_from: str = "", san_check_val_step: int = 2) -> None:
        """Train to max_epochs. SIGTERM / SIGUSR1 (a scheduler's grace
        period) finish the epoch in flight, force the boundary save, log a
        'preempt' line and raise the signal again; the ranks agree on the
        flag. Handlers install only on the main thread."""
        import signal

        self._preempt_signum = None
        saved_handlers = {}
        try:
            for sig in (signal.SIGTERM, signal.SIGUSR1):
                saved_handlers[sig] = signal.signal(sig,
                                                    self._on_preempt_signal)
        except ValueError:
            saved_handlers = {}
        try:
            self._fit(resume_from, san_check_val_step)
        finally:
            for sig, h in saved_handlers.items():
                signal.signal(sig, h)

    def _fit(self, resume_from: str, san_check_val_step: int) -> None:
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
            saved = (epoch + 1) % save_interval == 0 or last
            if saved:
                self.save(epoch, val_stats)
            if any_process_flag(self._preempt_signum is not None):
                if not saved:
                    self.save(epoch, val_stats)
                if self.is_main:
                    print(f"[preempt] saved epoch {epoch + 1}; exiting on "
                          f"signal {self._preempt_signum}", flush=True)
                _log_jsonl(self.log_file, {
                    "run_id": self.run_id, "split": "preempt",
                    "epoch": epoch, "signal": int(self._preempt_signum or 0)})
                self._reraise_preempt_signal()
                return

    def evaluate(self, max_steps: Optional[int] = None) -> Dict[str, float]:
        """Packed eval over the val loader (or its first `max_steps`
        batches); counters stay on the device until the end, then are
        summed over ranks. A full eval on one process also writes the
        validation GIFs (`visualize`)."""
        host_iter = (itertools.islice(self.val_loader, max_steps)
                     if max_steps is not None else self.val_loader)

        def prep(batch):
            if self._eval_buckets and "windows" in batch:
                batch = pack_view_batch(batch, self._eval_buckets,
                                        self.val_loader.shard_index,
                                        self.val_loader.num_shards)
            return self.device_batch(batch)

        results = [self.eval_step(b) for b in device_prefetch(host_iter, prep)]
        sums: Dict[str, float] = {}
        for res in results:
            for k, v in res.items():
                sums[k] = sums.get(k, 0.0) + float(v)
        if self.tp is not None and self.tp.model_index:
            # the ranks of a model group hold one data shard: count it once
            sums = {k: 0.0 for k in sums}
        sums = all_reduce_sum(sums)
        n = max(sums.pop("n", 1.0), 1.0)
        stats = {
            "probs_acc": sums.pop("probs_correct", 0.0) / n,
            "logits_acc": sums.pop("logits_correct", 0.0) / n,
            "ce_loss": sums.pop("ce_loss_sum", 0.0) / n,
        }
        for k, v in sums.items():
            stats[k.replace("_correct5", "_acc5")] = v / n
        stats["n"] = n
        if self.is_main:
            print(f"[val]   epoch {self.epoch}: {stats}", flush=True)
        _log_jsonl(self.log_file, {"run_id": self.run_id, "split": "val",
                                   "epoch": self.epoch, **stats})
        if self.visualize and max_steps is None and self.is_main \
                and process_count() == 1:
            # one rank's forwards alone: a multi-rank run skips it (its
            # metrics and checkpoints carry the run), as the JAX one does
            try:
                self._sample_events()
            except Exception as e:  # viz must never stop training
                print(f"[viz] skipped: {e}", flush=True)
        return stats

    def _sample_events(self) -> None:
        """Reference EventCLIPMethod._sample_events (method.py:103-148):
        `n_samples` val items through this trainer's forward on its
        device, written by utils.viz.visualize_samples."""
        from ..utils.viz import visualize_samples

        n = int(self.params.get("n_samples", 5))
        if n <= 0:
            return
        spec, pp = self.pipeline
        calls = [0, 0]

        @torch.inference_mode()
        def inputs_fn(windows, valid):
            calls[1] += 1
            w = torch.from_numpy(np.ascontiguousarray(windows)).to(
                self.device)
            return rasterize_for_clip(spec, pp, w).float().cpu().numpy()

        @torch.inference_mode()
        def probs_fn(windows, valid):
            calls[0] += 1
            w = torch.from_numpy(np.ascontiguousarray(windows)).to(
                self.device)
            v = torch.from_numpy(np.ascontiguousarray(valid)).to(self.device)
            imgs = rasterize_for_clip(spec, pp, w)
            out = classifier_forward(self.model_params, self.cls_cfg, imgs, v)
            return out["probs"].float().cpu().numpy()

        out_dir = os.path.join(self.ckpt_dir, "viz", f"epoch_{self.epoch}")
        try:
            visualize_samples(self.val_set, probs_fn, out_dir, n_samples=n,
                              inputs_fn=inputs_fn)
        finally:
            self.viz_forwards = tuple(calls)
