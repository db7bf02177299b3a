"""Reference FTCLIP training steps, in plain PyTorch float32 with TF32 off.

EventCLIP's FTCLIP with prompt tuning (`models/clip_cls_ft.py`,
`method.py` of Wuziyi616/EventCLIP) over an N-ImageNet reader, step by
step from the first:

- the batch: the loader's shuffle of the items, drawn from (seed, epoch);
- an item: its recording centred in the sensor frame (`windows.centred`),
  then the reader's augmentation, drawn from (seed, epoch, idx) in the
  reader's order: a time flip (p = 0.5; order reversed, t mirrored,
  polarity negated), a shift of dx, dy in [-max_shift, max_shift]
  (events pushed out of the frame dropped), a horizontal flip (p = 0.5);
  then its event-count windows, a random subset of `views` of them in
  random order where there are more, drawn from (seed, epoch, idx, 0xE77);
- the frames (`frames.py`), RandAugment on the frames with the step's
  draws (`randaugment.py`; the draws' generator seeded from
  `SeedSequence((seed, step, 0))`'s first word), CLIP's transform;
- the ViT over every view (`vit.py`), each view's feature L2-normalised
  and masked, logits = scale * feature . normalised text feature (the
  text features are trained), masked, their mean over the valid views,
  cross-entropy over the batch's mean;
- the gradient, summed over blocks of samples, and Adam (beta 0.9 /
  0.999, eps 1e-8, optax's bias correction) on every trained leaf, each
  group at its warm-up-cosine schedule read at the step's count: the
  text features at `lr`, the tower at `clip_lr`.

`rnd` rounds the tower's stored tensors as `vit.py` takes it, and with
`rounder` the gradients flowing back through them the same way: the
tower in bfloat16 storage (`rounder(vit.to_bf16)`), or in float8 e4m3
with a scale a tensor (`rounder(to_e4m3)`), the control.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

from . import frames, randaugment, vit, windows

E4M3_MAX = 448.0


def tf32_off() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def to_e4m3(t: torch.Tensor) -> torch.Tensor:
    """float8 e4m3 storage with one scale a tensor (its largest magnitude
    at e4m3's largest value, as fp8 training scales a tensor)."""
    amax = t.detach().abs().amax()
    scale = torch.where(amax > 0, amax / E4M3_MAX, torch.ones_like(amax))
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


def rounder(q: Callable) -> Callable:
    """`q` on a tensor in the forward and on its gradient in the backward."""

    class Round(torch.autograd.Function):
        @staticmethod
        def forward(ctx, t):
            return q(t)

        @staticmethod
        def backward(ctx, g):
            return q(g)

    return Round.apply


# -- data ----------------------------------------------------------------


def loader_order(seed: int, epoch: int, n: int) -> np.ndarray:
    """The items in the order an epoch's batches take them."""
    idx = np.arange(n)
    np.random.default_rng((seed, epoch)).shuffle(idx)
    return idx


def step_seeds(seed: int, step: int) -> Tuple[int, int]:
    a, f = np.random.SeedSequence((seed, step, 0)).generate_state(2)
    return int(a), int(f)


def item_windows(events: np.ndarray, seed: int, epoch: int, idx: int,
                 geo: Dict[str, Any]) -> List[np.ndarray]:
    """One item's [m, 3] x/y/p windows (valid views only)."""
    H, W, N = geo["height"], geo["width"], geo["window"]
    rng = np.random.default_rng((seed, epoch, idx))
    tflip = bool(rng.random() < 0.5) if geo["flip_time"] else False
    ms = geo["max_shift"]
    dx, dy = (int(v) for v in rng.integers(-ms, ms + 1, size=2))
    hflip = bool(rng.random() < 0.5)
    ev = windows.centred(np.asarray(events, dtype=np.float32), H, W)
    if tflip:
        ev = np.ascontiguousarray(ev[::-1])
        ev[:, 2] = ev[0, 2] - ev[:, 2]
        ev[:, 3] = -ev[:, 3]
    ev[:, 0] += dx
    ev[:, 1] += dy
    ev = ev[(ev[:, 0] >= 0) & (ev[:, 0] < W) & (ev[:, 1] >= 0)
            & (ev[:, 1] < H)]
    if hflip:
        ev[:, 0] = W - 1 - ev[:, 0]
    spans = windows.event_count_spans(len(ev), N)
    if len(spans) > geo["views"]:
        pick = np.random.default_rng((seed, epoch, idx, 0xE77)).permutation(
            len(spans))[:geo["views"]]
        spans = [spans[i] for i in pick]
    return [ev[a:b][:, (0, 1, 3)] for a, b in spans]


def batch_images(items: Sequence[Tuple[np.ndarray, int]], seed: int,
                 epoch: int, step: int, geo: Dict[str, Any], device,
                 augment: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """[(events, idx)] -> ([B, T, 3, S, S] CLIP inputs, [B, T] valid)."""
    B, T, H, W = len(items), geo["views"], geo["height"], geo["width"]
    per = [item_windows(ev, seed, epoch, idx, geo) for ev, idx in items]
    valid = torch.zeros((B, T), dtype=torch.bool)
    wins = []
    for b, ws in enumerate(per):
        valid[b, :len(ws)] = True
        wins += ws + [np.zeros((0, 3), np.float32)] * (T - len(ws))
    img = frames.frames(frames.histograms(wins, H, W, device),
                        geo["thresh"], geo["grey"]).reshape(B, T, 3, H, W)
    if augment:
        gen = torch.Generator(device=device).manual_seed(
            step_seeds(seed, step)[0])
        names, mags = randaugment.draws(gen, B, geo["num_ops"], H, W)
        img = img.clone()
        for b in range(B):
            for t in range(T):
                f = img[b, t]
                for name, mag in zip(names[b], mags[b]):
                    f = randaugment.apply_op(f, name, mag)
                img[b, t] = f
    x = frames.clip_inputs(img.reshape(B * T, 3, H, W), geo["image_size"])
    return x.reshape(B, T, 3, geo["image_size"], geo["image_size"]), \
        valid.to(device)


# -- the head and the step ---------------------------------------------------


def normalize(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True),
                           min=1e-12)


def ce_sum(feats: torch.Tensor, valid: torch.Tensor, text: torch.Tensor,
           labels: torch.Tensor, scale: float) -> torch.Tensor:
    """[B, T, C] raw features -> the sum over the B samples of the
    cross-entropy of their mean logits over the valid views."""
    vm = valid.float()
    f = normalize(feats) * vm[..., None]
    logits = scale * torch.einsum("btc,nc->btn", f, normalize(text))
    logits = logits * vm[..., None]
    mean = logits.sum(1) / vm.sum(1, keepdim=True)
    logp = torch.log_softmax(mean, dim=-1)
    return -logp.gather(-1, labels[:, None])[:, 0].sum()


def warmup_cosine(max_lr: float, total: int, pct: float, step: int) -> float:
    """nerv's warm-up cosine (no restart), from max_lr / 100."""
    lo, warm = max_lr * 0.01, pct * total
    if step < warm:
        return lo + (max_lr - lo) * step / warm
    t = min(max((step - warm) / max(total - warm, 1.0), 0.0), 1.0)
    return lo + (max_lr - lo) * 0.5 * (1.0 + math.cos(math.pi * t))


class Adam:
    """Adam with optax's defaults over {name: leaf}, one lr a leaf."""

    def __init__(self, leaves: Dict[str, torch.Tensor], b1=0.9, b2=0.999,
                 eps=1e-8):
        self.b1, self.b2, self.eps, self.t = b1, b2, eps, 0
        self.m = {k: torch.zeros_like(v) for k, v in leaves.items()}
        self.v = {k: torch.zeros_like(v) for k, v in leaves.items()}

    @torch.no_grad()
    def step(self, leaves, grads, lrs: Dict[str, float]) -> None:
        self.t += 1
        c1, c2 = 1.0 - self.b1 ** self.t, 1.0 - self.b2 ** self.t
        for k, p in leaves.items():
            g = grads[k]
            self.m[k].mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            den = self.v[k].sqrt() / math.sqrt(c2) + self.eps
            p.sub_(lrs[k] / c1 * self.m[k] / den)


def train_steps(batches: Sequence[Dict[str, Any]],
                weights: Dict[str, torch.Tensor], text: torch.Tensor,
                geo: Dict[str, Any], opt: Dict[str, Any],
                block: int = 8, rnd: Callable = vit.exact,
                augment: bool = True) -> Dict[str, Any]:
    """Train from `weights` (OpenAI names) and `text` over `batches`, each
    {'items': [(events, idx)], 'labels': [B] ints, 'epoch', 'step'}.

    geo: height, width, window, views, layers, heads, image_size, thresh,
    grey, max_shift, flip_time, num_ops, logit_scale, seed (the data's and
    the draws' seed). opt: lr, clip_lr, total_steps, warmup_pct. -> {
    'losses': each step's loss, 'grad1': {name: the first step's
    gradient}, 'delta': {name: the change over the steps}, 'text' under
    the name 'text'}."""
    tf32_off()
    device = text.device
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in weights.items()}
    leaves["text"] = text.detach().clone().requires_grad_(True)
    start = {k: v.detach().clone() for k, v in leaves.items()}
    adam = Adam(leaves)
    losses, grad1 = [], None
    for b in batches:
        x, valid = batch_images(b["items"], geo["seed"], b["epoch"],
                                b["step"], geo, device, augment)
        labels = torch.as_tensor(b["labels"], device=device).long()
        B, T = valid.shape
        total = 0.0
        for a in range(0, B, block):
            sl = slice(a, min(a + block, B))
            xb = x[sl].reshape((-1,) + tuple(x.shape[2:]))
            feats = vit.encode(xb, leaves, geo["layers"], geo["heads"], rnd)
            loss = ce_sum(feats.reshape(-1, T, feats.shape[-1]), valid[sl],
                          leaves["text"], labels[sl], geo["logit_scale"]) / B
            loss.backward()
            total += float(loss.detach())
        losses.append(total)
        grads = {k: v.grad for k, v in leaves.items()}
        if grad1 is None:
            grad1 = {k: g.detach().clone() for k, g in grads.items()}
        lr_text = warmup_cosine(opt["lr"], opt["total_steps"],
                                opt["warmup_pct"], b["step"])
        lr_tower = warmup_cosine(opt["clip_lr"], opt["total_steps"],
                                 opt["warmup_pct"], b["step"])
        adam.step(leaves, grads, {k: lr_text if k == "text" else lr_tower
                                  for k in leaves})
        for v in leaves.values():
            v.grad = None
    delta = {k: (leaves[k].detach() - start[k]) for k in leaves}
    return {"losses": losses, "grad1": grad1, "delta": delta}
