"""Train and eval steps on one device.

Port of eventclip_tpu/engine/train.py (`make_train_step`,
`make_eval_step`) for a single card: the JAX package's mesh, GSPMD
sharding, ZeRO-1 and tensor parallelism are multi-GPU work for a later
slice. PyTorch runs eagerly, so a "step" is a plain function that updates
the parameters in place.

Mixed precision: master parameters live in float32; the visual tower's
activations run in the classifier's dtype (bfloat16 by default).

Randomness: each step draws RandAugment's ops and the FS adapter's dropout
masks from generators on the batch's device, seeded from (seed, update
count, microbatch, stream), as the JAX step folds the update count into its
key and splits it into augment and forward keys. A resumed run draws the
same at the same step.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..models.classifier import (ClassifierConfig, ClassifierParams,
                                 classifier_forward, classifier_forward_packed,
                                 per_sample_ce, train_loss)
from ..ops.randaugment import sample_ops
from ..ops.rasterize import rasterize_augment_for_clip, rasterize_for_clip
from .optim import Optimizer

Batch = Dict[str, torch.Tensor]
RANDAUGMENT_OPS = 2  # num_ops in every reference config


def _batch_images(batch: Batch, pipeline,
                  augment: Optional[torch.Generator] = None) -> torch.Tensor:
    """Model inputs: precomputed 'img', or on-device rasterization of raw
    event 'windows' (the histogram kernel, then frame finish and CLIP
    preprocess), with RandAugment drawn from `augment` when given."""
    if "img" in batch:
        return batch["img"]
    spec, pp = pipeline
    with torch.no_grad():
        windows = batch["windows"]
        if augment is None:
            return rasterize_for_clip(spec, pp, windows)
        draws = sample_ops(augment, windows.shape[0], RANDAUGMENT_OPS,
                           spec.height, spec.width)
        return rasterize_augment_for_clip(spec, pp, windows, *draws)


def step_seeds(seed: int, count: int, microbatch: int) -> Tuple[int, int]:
    """(augment, forward) seeds for one microbatch of the update numbered
    `count`: a function of these numbers alone."""
    a, f = np.random.SeedSequence((seed, count, microbatch)).generate_state(2)
    return int(a), int(f)


def make_train_step(
    cfg: ClassifierConfig,
    params: ClassifierParams,
    optimizer: Optimizer,
    loss_weights: Optional[Dict[str, float]] = None,
    pipeline=None,
    augment: bool = False,
    accum_steps: int = 1,
    seed: int = 0,
) -> Callable[[Batch], Dict[str, torch.Tensor]]:
    """Build the train step: batch -> metrics (0-d tensors on the device,
    fetched by the caller when it likes); the parameters and the
    optimizer are updated in place.

    batch: {'img': [B,T,3,S,S] f32 | 'windows': [B,T,N,3|4],
            'valid_mask': [B,T] bool, 'label': [B] int}
    pipeline: (RasterSpec, ClipPreprocess) for 'windows' batches.
    augment=True applies on-device RandAugment (the config's img_aug) to
        'windows' batches between the rasterizer and the resize.
    accum_steps > 1 splits the batch into that many equal microbatches
        along dim 0 and runs them one after another: the gradient is the
        mean of the microbatch gradients, one optimizer update per call,
        and only one microbatch's activations are live at a time.
    seed: the draws' seed (see the module docstring); the forward runs
        with train=True, so the FS adapter's dropout is on.
    """
    loss_weights = dict(loss_weights or {})
    accum = int(accum_steps)
    assert accum >= 1, accum
    generators: Dict[torch.device, Tuple[torch.Generator, ...]] = {}

    def loss_fn(mb: Batch, i: int):
        dev = mb["label"].device
        if dev not in generators:  # made once, seeded every microbatch
            generators[dev] = (torch.Generator(device=dev),
                               torch.Generator(device=dev))
        gen_aug, gen_fwd = generators[dev]
        s_aug, s_fwd = step_seeds(seed, optimizer.count, i)
        gen_aug.manual_seed(s_aug)
        gen_fwd.manual_seed(s_fwd)
        imgs = _batch_images(mb, pipeline, gen_aug if augment else None)
        out = classifier_forward(params, cfg, imgs, mb["valid_mask"],
                                 train=True, generator=gen_fwd)
        losses = train_loss(cfg, out, mb["label"])
        # nerv convention: total = sum(loss * params.<name>_w)
        total = sum(v * loss_weights.get(k, 1.0) for k, v in losses.items())
        losses["total_loss"] = total
        losses["train_acc"] = (out["probs"].argmax(-1)
                               == mb["label"]).float().mean()
        return total, losses

    def step(batch: Batch) -> Dict[str, torch.Tensor]:
        optimizer.zero_grad()
        B = batch["label"].shape[0]
        assert B % accum == 0, (B, accum)
        metrics: Dict[str, torch.Tensor] = {}
        for i in range(accum):
            mb = {k: v[i * B // accum:(i + 1) * B // accum]
                  for k, v in batch.items()}
            total, losses = loss_fn(mb, i)
            total.backward()
            for k, v in losses.items():
                metrics[k] = metrics.get(k, 0.0) + v.detach()
        if accum > 1:
            # the summed microbatch gradients -> their mean; equal
            # microbatch sizes make the mean of the metrics the batch's
            with torch.no_grad():
                for p in optimizer.norm_params:
                    if p.grad is not None:
                        p.grad.mul_(1.0 / accum)
            metrics = {k: v / accum for k, v in metrics.items()}
        optimizer.step()
        return metrics

    return step


def make_eval_step(cfg: ClassifierConfig, params: ClassifierParams,
                   top5: bool = False, pipeline=None
                   ) -> Callable[[Batch], Dict[str, torch.Tensor]]:
    """Eval step returning summed counters (0-d tensors; the caller sums
    them over batches). The batch adds 'sample_mask' [B] bool so a padded
    final batch counts only its real rows; a batch carrying 'view_src'
    (data.loader.pack_view_batch) is view-packed and only its real views
    are rasterized and encoded."""

    @torch.inference_mode()
    def step(batch: Batch) -> Dict[str, torch.Tensor]:
        if "view_src" in batch:
            spec, pp = pipeline
            imgs = rasterize_for_clip(spec, pp, batch["windows"])
            out = classifier_forward_packed(params, cfg, imgs,
                                            batch["view_src"],
                                            batch["valid_mask"])
        else:
            out = classifier_forward(params, cfg,
                                     _batch_images(batch, pipeline),
                                     batch["valid_mask"])
        m = batch["sample_mask"].float()
        label = batch["label"].long()
        res = {
            "n": m.sum(),
            "probs_correct": ((out["probs"].argmax(-1) == label) * m).sum(),
            "logits_correct": ((out["logits"].argmax(-1) == label) * m).sum(),
            # per-sample CE, masked (padded rows can hold NaN aggregations)
            "ce_loss_sum": torch.where(m > 0, per_sample_ce(cfg, out, label),
                                       0.0).sum(),
        }
        if top5:
            for name in ("probs", "logits"):
                idx = out[name].topk(5, dim=-1).indices
                res[f"{name}_correct5"] = (
                    (idx == label[:, None]).any(-1) * m).sum()
        return res

    return step
