#!/usr/bin/env python3
"""Drive the PyTorch port's serving, FT- and FS-training paths on one card.

    python3 chip_smoke.py

Phases (each prints its lines; any failure raises, so the exit code is
non-zero):

1. device: the card's name and power limit, torch / CUDA versions; build
   every CUDA kernel from eventclip_tpu_torch/csrc (one nvcc per source, all
   at once).
2. kernels vs plain on the card, at the main paths' shapes: the event
   histogram K1 (exact) on N-Caltech serving, N-Cars, the N-ImageNet
   training batch [256, 70000, 3] @ 480x640, the N-Caltech FS training
   batch [64, 20000, 3] @ 180x240, a 720x1280 frame (row bands)
   and windows with every event on one pixel; the fused-qkv attention
   forward K2 and its backward K3 on the ViT-L/14 (bf16, no mask; serving
   and training batches, and the FS step's [64, 257, 3072]), text tower
   (f32, causal mask) and tiny-tower
   (dh 32 / 16) shapes; f32 K2 / K3 at [8, 257, 3072], at phase 7's
   [64, 257, 3072] and at ViT-L/14@336's S = 577; bf16 K2 / K3 with the
   causal mask at S = 77 and
   at S = 577; K4, the [B, H, S, dh] attention, forward and backward.
   bf16 attention runs on the tensor-core kernels, f32 on the
   CUDA-core ones. Each attention check holds the max |kernel - plain| and,
   for each output apart, ||kernel - plain|| / ||plain|| to their limits;
   at one shape the bf16 kernels' relative error is printed beside that of
   three other rounding orders, which must miss the limit. Each prints
   kernel ms, plain ms, the bound, one library call's ms as a yardstick
   and the kernel's factor over it.
3. serving: configs/zsclip/zsclip_ncaltech_params.py through the port's
   loader, random ViT-L/14 towers from a seeded generator, text features
   for 101 synthetic prompts through the text tower, a Predictor at
   batch 32 answering requests of 32 x 225k, 8 x 30-60k and 1 x 5k events,
   three times each. Launch counters are zeroed just before these timed
   requests and read just after them (the text tower's and the warm-up's
   counts are printed apart); then one request is profiled.
4. serving card vs CPU: one short stream through the same towers on the
   CPU (float32, plain kernels); cosine of the view features.
5. FT training: configs/ftclip/ft_text_fsclip_nin_params.py (ViT-L/14 full
   fine-tune with prompt tuning, N-ImageNet 480x640, N = 70000, batch 128
   x 2 views, bf16, remat) with random towers from a seeded generator, on
   an in-memory synthetic N-ImageNet set made per item from (seed, idx),
   with the config's img_aug (on-device RandAugment in the step). The
   EventCLIPTrainer runs its sanity eval, then one epoch of 4 steps with
   the launch counters zeroed just before and read just after (K1 1, K2 48,
   K3 24 per step); then one step is profiled (RandAugment's device ms
   apart), trained and frozen leaves are checked, the trainable checkpoint
   is saved, the parameters moved by one more step, the checkpoint
   reloaded and evaluated to the same counters.
6. FT update card vs CPU: a 2-layer ViT-L/14 at full width, f32, one
   update on the same small batch with the kernels on the card and the
   plain versions on the CPU; gradient cosine and relative differences.
7. f32 FT training: phase 5's config and trainer with bf16 = False set on
   the loaded config (f32 end to end, the f32 K2 and K3 kernels), ViT-L/14
   at full width and depth with remat, batch cut from 128 to 32 (x 2
   views), augment off; sanity eval, 3 timed steps with the counters zeroed
   just before and read just after (K1 1, K2 48, K3 24 per step), one
   profiled step (K3 f32's share of it).
8. FS training: configs/fsclip/joint_adapter/joint_fsclip_ncaltech_params.py
   at its own size (ViT-L/14 frozen in bf16, the text-trans adapter with
   prompt tuning, N-Caltech 180x240, N = 20000, batch 32 x 2 views, val 64
   x 10 views, img_aug) with random towers, on an in-memory synthetic
   N-Caltech set (101 classes, made per item from (seed, idx)); first
   RandAugment on the card against the CPU on the same frames and draws
   (all 14 ops, at phase 5's and this phase's frame sizes); then the
   trainer as in phase 5: sanity eval, 4 timed steps (K1 1, K2 24, K3 0 per
   step: the tower is frozen, no remat, no backward through it), one
   profiled step (RandAugment, adapter and text-feature ms apart), adapter
   and prompts moved while the towers and logit scale stay, checkpoint
   round trip.

Then one JSON line with every kernel's numbers, the card's name and power
limit, and as the last line {"ok": true, "device": {...}}. Imports nothing
of JAX. Fails when no CUDA device is present or the port is missing.
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # dense, per dtype
ATOL = {"float32": 1e-5, "bfloat16": 2e-2}  # kernel vs plain, see PERF.md
# ||kernel - plain|| / ||plain||, each output apart. In bf16 the max-abs
# limit is a fifth of a typical output, too loose to tell the TPU kernels'
# rounding order from another one; this limit tells them apart (see
# other_rounding_orders and PERF.md)
REL = {"float32": 1e-6, "bfloat16": 5e-4}


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() over `iters` launches (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


# -- phase 2: kernels vs their plain versions --------------------------------


def synth_windows(gen, M, N, H, W, dev, pile=False):
    """Packed int16 [M, N, 3] windows with out-of-bounds and p == 0 rows;
    with `pile`, every event of a window on one pixel, of one polarity."""
    import torch

    x = torch.randint(-20, W + 20, (M, N), generator=gen, device=dev)
    y = torch.randint(-20, H + 20, (M, N), generator=gen, device=dev)
    p = torch.randint(-1, 2, (M, N), generator=gen, device=dev)
    if pile:
        x, y = torch.full_like(x, W // 3), torch.full_like(y, H // 2)
        p = torch.where(torch.arange(M, device=dev)[:, None] % 2 == 0, 1, -1
                        ).expand(M, N)
    return torch.stack([x, y, p], dim=-1).to(torch.int16).contiguous()


def check_histogram(gen, name, M, N, H, W, dev, pile=False):
    import torch

    from eventclip_tpu_torch.ops import numpy_ref
    from eventclip_tpu_torch.ops.rasterize import (device_histogram_plan,
                                                   histograms,
                                                   histograms_plain)

    wins = synth_windows(gen, M, N, H, W, dev, pile)
    got = histograms(wins, H, W)
    want = histograms_plain(wins, H, W)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(f"histogram {name}: kernel != plain")
    # the numpy oracle on the first window
    w0 = wins[0].cpu().numpy().astype(np.int64)
    keep = (w0[:, 0] >= 0) & (w0[:, 0] < W) & (w0[:, 1] >= 0) & (w0[:, 1] < H)
    ref = numpy_ref.polarity_histogram(w0[keep, 0], w0[keep, 1], w0[keep, 2],
                                       (H, W))
    if not np.array_equal(got[0].cpu().numpy(),
                          np.moveaxis(ref, -1, 0).astype(np.float32)):
        raise AssertionError(f"histogram {name}: kernel != numpy oracle")
    # f32 [.., 4] layout once, exact as well
    w4 = torch.cat([wins[..., :2], torch.zeros_like(wins[..., :1]),
                    wins[..., 2:]], -1).float().contiguous()
    if not torch.equal(histograms(w4, H, W), got):
        raise AssertionError(f"histogram {name}: f32 layout != packed")

    # yardstick: one bincount over the precomputed flat indices of live events
    x, y, p = (wins[..., i].long() for i in range(3))
    live = (x >= 0) & (x < W) & (y >= 0) & (y < H) & (p != 0)
    m = torch.arange(M, device=dev)[:, None]
    flat = ((m * 2 * H + y + H * (p < 0).long()) * W + x)[live]
    ms = cuda_ms(lambda: histograms(wins, H, W))
    plain_ms = cuda_ms(lambda: histograms_plain(wins, H, W))
    library_ms = cuda_ms(lambda: torch.bincount(flat, minlength=M * 2 * H * W))
    nbytes = wins.numel() * 2 + M * 2 * H * W * 4
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    plan = device_histogram_plan(dev, H, W)  # the plan `histograms` ran
    shape = f"[{M}, {N}, 3] int16 @ {H}x{W}"
    log(f"K1 histogram {name} {shape} (clusters of {plan.cluster} CTAs x "
        f"{plan.rows} rows, {plan.bands} band(s)): exact; kernel {ms:.4f} "
        f"ms, plain {plain_ms:.4f} ms, bincount {library_ms:.4f} ms (kernel "
        f"/ bincount {ms / library_ms:.2f}x), bound {bound_ms:.4f} ms "
        "(bytes)")
    return dict(shape=shape, max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by="bytes", library_ms=library_ms)


def attention_bound(nbytes, flops, tname):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[tname] * 1e3
    return max((t_bytes, "bytes"), (t_ops, "operations"))


def max_err(got, want):
    return max(float((a.float() - b.float()).abs().max())
               for a, b in zip(got, want))


def rel_errs(got, want):
    """||a - b|| / ||b|| of each output pair (0 where both are 0)."""
    return [float((a.double() - b.double()).norm()
                  / b.double().norm().clamp_min(1e-30))
            for a, b in zip(got, want)]


def hold(name, got, want, tname):
    """(max |kernel - plain|, [||kernel - plain|| / ||plain|| per output]),
    each held to its limit."""
    err, rel = max_err(got, want), rel_errs(got, want)
    if not (err <= ATOL[tname] and max(rel) <= REL[tname]):
        raise AssertionError(
            f"{name}: max |kernel - plain| {err} (<= {ATOL[tname]}), "
            f"||kernel - plain|| / ||plain|| {rel} (<= {REL[tname]})")
    return err, rel


def other_rounding_orders(q, k, v, g):
    """||variant - plain|| / ||plain|| of attention computed as the TPU
    kernels do but for one rounding step, from [B, H, S, dh] bf16 q, k, v
    and g (no mask). Each must miss REL, or the limit could not tell the
    kernels' rounding order from another one."""
    import torch

    from eventclip_tpu_torch.ops.attention import (attention_bwd_plain,
                                                   attention_plain)

    dt, scale = q.dtype, q.shape[-1] ** -0.5
    qf, kf, vf, gf = (t.float() for t in (q, k, v, g))
    s = qf @ kf.transpose(-1, -2) * scale
    e = torch.exp(s - s.amax(-1, keepdim=True))
    total = e.sum(-1, keepdim=True)
    p = e / total
    dp = gf @ vf.transpose(-1, -2)

    def dq_dk(ds):
        ds = (ds * scale).to(dt).float()
        return [(ds @ kf).to(dt), (ds.transpose(-1, -2) @ qf).to(dt)]

    o = attention_plain(q, k, v)
    dq, dk, _ = attention_bwd_plain(q, k, v, g)
    return {
        "o, p divided by its sum after p . v": max(rel_errs(
            [((e.to(dt).float() @ vf) / total).to(dt)], [o])),
        "dq/dk, FlashAttention's delta = rowsum(g * o)": max(rel_errs(
            dq_dk(p * (dp - (gf * o.float()).sum(-1, keepdim=True))),
            [dq, dk])),
        "dq/dk, ds from the rounded p": max(rel_errs(
            dq_dk(p.to(dt).float() * (dp - (dp * p).sum(-1, keepdim=True))),
            [dq, dk])),
    }


def fmt(rel):
    return "/".join(f"{r:.3g}" for r in rel)


def check_attention(gen, name, B, S, heads, dh, dtype, causal, dev):
    import torch
    import torch.nn.functional as F

    from eventclip_tpu_torch.models.clip.model import causal_mask
    from eventclip_tpu_torch.ops.attention import (fused_qkv_attention,
                                                   qkv_attention_plain)

    D = heads * dh
    qkv = torch.randn((B, S, 3 * D), generator=gen, device=dev).to(dtype)
    mask = causal_mask(S, device=dev) if causal else None
    got = fused_qkv_attention(qkv, heads, mask)
    want = qkv_attention_plain(qkv, heads, mask)
    torch.cuda.synchronize()
    tname = str(dtype).split(".")[-1]
    err, rel = hold(f"attention {name}", [got], [want], tname)

    q, k, v =(t.reshape(B, S, heads, dh).transpose(1, 2).contiguous()
               for t in qkv.split(D, -1))
    ms = cuda_ms(lambda: fused_qkv_attention(qkv, heads, mask))
    plain_ms = cuda_ms(lambda: qkv_attention_plain(qkv, heads, mask))
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=causal))
    esize = qkv.element_size()
    nbytes = (B * S * 3 * D + B * S * D) * esize + (S * S * 4 if causal else 0)
    bound_ms, bound_by = attention_bound(nbytes, 4 * B * heads * S * S * dh,
                                         tname)
    shape = f"[{B}, {S}, {3 * D}] {tname}"
    log(f"K2 attention {name} {shape} heads={heads} dh={dh} "
        f"mask={'causal' if causal else 'none'}: max_abs_err {err:.3g}"
        f" (atol {ATOL[tname]}), rel_err {fmt(rel)} (limit {REL[tname]}); "
        f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa "
        f"{library_ms:.4f} ms (kernel / sdpa {ms / library_ms:.2f}x), bound"
        f" {bound_ms:.4f} ms ({bound_by})")
    return dict(shape=shape, max_abs_err=err, rel_err=max(rel), ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=library_ms)


def check_attention_bwd(gen, name, B, S, heads, dh, dtype, causal, dev):
    """K3 in the fused layout against its plain version; yardstick: the
    backward alone of scaled_dot_product_attention (autograd.grad on a
    kept graph)."""
    import torch
    import torch.nn.functional as F

    from eventclip_tpu_torch.models.clip.model import causal_mask
    from eventclip_tpu_torch.ops.attention import (qkv_attention_bwd,
                                                   qkv_attention_bwd_plain)

    D = heads * dh
    qkv = torch.randn((B, S, 3 * D), generator=gen, device=dev).to(dtype)
    g = torch.randn((B, S, D), generator=gen, device=dev).to(dtype)
    mask = causal_mask(S, device=dev) if causal else None
    got = qkv_attention_bwd(qkv, g, heads, mask)
    again = qkv_attention_bwd(qkv, g, heads, mask)
    want = qkv_attention_bwd_plain(qkv, g, heads, mask)
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise AssertionError(f"attention bwd {name}: two runs differ")
    tname = str(dtype).split(".")[-1]
    # dq, dk and dv apart
    err, rel = hold(f"attention bwd {name}", got.split(D, -1),
                    want.split(D, -1), tname)

    q, k, v =(t.reshape(B, S, heads, dh).transpose(1, 2).contiguous()
               .requires_grad_() for t in qkv.split(D, -1))
    gh = g.reshape(B, S, heads, dh).transpose(1, 2).contiguous()
    out = F.scaled_dot_product_attention(q, k, v, is_causal=causal)
    ms = cuda_ms(lambda: qkv_attention_bwd(qkv, g, heads, mask))
    plain_ms = cuda_ms(lambda: qkv_attention_bwd_plain(qkv, g, heads, mask),
                       iters=5)
    library_ms = cuda_ms(lambda: torch.autograd.grad(
        out, (q, k, v), gh, retain_graph=True))
    esize = qkv.element_size()
    nbytes = B * S * 7 * D * esize + (S * S * 4 if causal else 0)
    bound_ms, bound_by = attention_bound(
        nbytes, 10 * B * heads * S * S * dh, tname)
    shape = f"[{B}, {S}, {3 * D}] {tname} + g"
    log(f"K3 attention bwd {name} {shape} heads={heads} dh={dh} "
        f"mask={'causal' if causal else 'none'}: max_abs_err {err:.3g} "
        f"(atol {ATOL[tname]}), rel_err dq/dk/dv {fmt(rel)} (limit "
        f"{REL[tname]}), two runs bit-equal; kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, sdpa backward {library_ms:.4f} ms (kernel / "
        f"sdpa {ms / library_ms:.2f}x), bound {bound_ms:.4f} ms ({bound_by})")
    return dict(shape=shape, max_abs_err=err, rel_err=max(rel), ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=library_ms)


def check_bhsd_attention(gen, name, B, S, heads, dh, dtype, causal, dev):
    """K4 (the [B, H, S, dh] forward) and its backward (K3 with these
    strides) against their plain versions; yardstick: sdpa forward."""
    import torch
    import torch.nn.functional as F

    from eventclip_tpu_torch.models.clip.model import causal_mask
    from eventclip_tpu_torch.ops.attention import (attention_bwd,
                                                   attention_bwd_plain,
                                                   attention_plain,
                                                   multi_head_attention)

    q, k, v, g = (torch.randn((B, heads, S, dh), generator=gen, device=dev)
                  .to(dtype) for _ in range(4))
    mask = causal_mask(S, device=dev) if causal else None
    got = multi_head_attention(q, k, v, mask)
    want = attention_plain(q, k, v, mask)
    gots = attention_bwd(q, k, v, g, mask)
    wants = attention_bwd_plain(q, k, v, g, mask)
    torch.cuda.synchronize()
    tname = str(dtype).split(".")[-1]
    err, rel = hold(f"attention [B, H, S, dh] {name} forward", [got], [want],
                    tname)
    err_bwd, rel_bwd = hold(f"attention [B, H, S, dh] {name} backward", gots,
                            wants, tname)
    ms =cuda_ms(lambda: multi_head_attention(q, k, v, mask))
    plain_ms = cuda_ms(lambda: attention_plain(q, k, v, mask))
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=causal))
    bwd_ms = cuda_ms(lambda: attention_bwd(q, k, v, g, mask))
    nbytes = 4 * B * heads * S * dh * q.element_size()
    bound_ms, bound_by = attention_bound(nbytes, 4 * B * heads * S * S * dh,
                                         tname)
    shape = f"[{B}, {heads}, {S}, {dh}] {tname}"
    log(f"K4 attention {shape} {name}: forward max_abs_err {err:.3g}, "
        f"rel_err {fmt(rel)}; backward (K3 on these strides) max_abs_err "
        f"{err_bwd:.3g}, rel_err dq/dk/dv {fmt(rel_bwd)} (atol {ATOL[tname]},"
        f" limit {REL[tname]}); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"sdpa {library_ms:.4f} ms (kernel / sdpa {ms / library_ms:.2f}x), "
        f"bound {bound_ms:.4f} ms ({bound_by}); K3 backward here "
        f"{bwd_ms:.4f} ms")
    return dict(shape=shape, max_abs_err=err, rel_err=max(rel), ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=library_ms)


def check_rounding_orders(gen, B, S, heads, dh, dev):
    """The bf16 kernels' rel_err beside that of three other rounding
    orders, on the same inputs: the kernels must pass REL, the others
    must miss it."""
    import torch

    from eventclip_tpu_torch.ops.attention import (attention_bwd,
                                                   attention_bwd_plain,
                                                   attention_plain,
                                                   multi_head_attention)

    q, k, v, g = (torch.randn((B, heads, S, dh), generator=gen, device=dev)
                  .bfloat16() for _ in range(4))
    kernel = {
        "o": max(rel_errs([multi_head_attention(q, k, v)],
                          [attention_plain(q, k, v)])),
        "dq/dk/dv": max(rel_errs(attention_bwd(q, k, v, g),
                                 attention_bwd_plain(q, k, v, g))),
    }
    other = other_rounding_orders(q, k, v, g)
    limit = REL["bfloat16"]
    log(f"rounding orders at [{B}, {heads}, {S}, {dh}] bf16, "
        f"||x - plain|| / ||plain|| (limit {limit}): the kernels "
        + ", ".join(f"{n} {r:.3g}" for n, r in kernel.items())
        + "; other orders " + ", ".join(f"{n} {r:.3g}"
                                        for n, r in other.items()))
    if max(kernel.values()) > limit or min(other.values()) <= limit:
        raise AssertionError(
            f"rounding orders: kernels {kernel}, others {other}, limit "
            f"{limit}")
    return dict(kernels=kernel, other_orders=other, limit=limit)


# -- phase 3: the main path ---------------------------------------------------


def synth_stream(rng, n, H=180, W=240):
    """[n, 4] x/y/t/p events: a moving blob over background noise."""
    t = np.sort(rng.uniform(0.0, 0.3, n))
    cx = 60 + 120 * t / 0.3 + rng.normal(0, 25, n)
    cy = 90 + rng.normal(0, 30, n)
    noise = rng.random(n) < 0.2
    x = np.where(noise, rng.integers(0, W, n), np.clip(cx, 0, W - 1))
    y = np.where(noise, rng.integers(0, H, n), np.clip(cy, 0, H - 1))
    p = rng.choice([-1.0, 1.0], n)
    return np.stack([np.floor(x), np.floor(y), t, p], 1).astype(np.float32)


def synth_prompts(rng, n_cls, context):
    """[n_cls, context] ids: SOT, random ids below 49406, EOT 49407 (the
    highest id, so encode_text's argmax pools there), zero padding."""
    toks = np.zeros((n_cls, context), np.int64)
    for i in range(n_cls):
        L = int(rng.integers(5, 20))
        toks[i, 0] = 49406
        toks[i, 1:L + 1] = rng.integers(1, 49406, L)
        toks[i, L + 1] = 49407
    return toks


# torch.profiler.record_function ranges in the port (ops/rasterize.py,
# models/classifier.py); on the card each also shows as a row of its own,
# the span of its kernels, which is not kernel time
RANGES = ("randaugment", "adapter", "text_feats")


def profile_call(tag, label, fn):
    """Device time by kernel over one call of fn() (torch.profiler), and
    the device's busy share of the call's wall time; returns the wall and
    busy ms, every (ms, count, name) kernel row, and for each RANGES range
    in the call its kernels' ms and its span on the device."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows, spans = [], {}
    for evt in prof.key_averages():
        if getattr(evt, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        if evt.key in RANGES:
            spans[evt.key] = us / 1e3
        else:
            rows.append((us / 1e3, evt.count, evt.key))
    if not rows:
        log(f"[{tag}] {label}: the profiler saw no device time; device "
            "breakdown not measured")
        return None
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    log(f"[{tag}] {label}: wall {wall_ms:.1f} ms, device busy {busy:.1f} ms "
        f"({100 * busy / wall_ms:.1f}%), idle "
        f"{100 * (1 - busy / wall_ms):.1f}%")
    for ms, count, key in rows[:12]:
        log(f"[{tag}]   {ms:9.3f} ms  {100 * ms / busy:5.1f}%  x{count:<5d}"
            f" {key[:90]}")
    ranges = {}
    for name in RANGES:
        ms = annotated_ms(prof, name)
        if ms is None:
            continue
        ranges[name] = dict(kernel_ms=ms, span_ms=spans.get(name))
        log(f"[{tag}]   range {name}: kernels {ms:.3f} ms "
            f"({100 * ms / busy:.1f}% of busy) over a device span of "
            + ("not measured" if name not in spans else
               f"{spans[name]:.3f} ms"))
    return dict(wall_ms=wall_ms, busy_ms=busy, rows=rows, ranges=ranges)


def check_probs(out, n, n_cls):
    probs = out["probs"]
    assert probs.shape == (n, n_cls), probs.shape
    assert np.isfinite(probs).all(), "non-finite probs"
    assert np.allclose(probs.sum(-1), 1.0, atol=1e-3), probs.sum(-1)


# -- phases 5-8: training ----------------------------------------------------


def synth_events(rng, n, label, H, W, max_t):
    """[n, 4] x/y/t/p: a blob whose place and drift depend on the label,
    over 30% uniform noise."""
    cx = W * (0.15 + 0.7 * (label % 40) / 40)
    cy = H * (0.15 + 0.7 * (label // 40) / 25)
    t = np.arange(n, dtype=np.float32) * (max_t / n)
    noise = rng.random(n) < 0.3
    x = np.where(noise, rng.integers(0, W, n),
                 np.clip(cx + 0.1 * W * t / max_t + rng.normal(0, W / 20, n),
                         0, W - 1))
    y = np.where(noise, rng.integers(0, H, n),
                 np.clip(cy + rng.normal(0, H / 16, n), 0, H - 1))
    p = np.where(rng.random(n) < 0.5, -1.0, 1.0)
    return np.stack([np.floor(x), np.floor(y), t, p], 1).astype(np.float32)


class SyntheticEvents:
    """In-memory stand-in for an event dataset: item idx is made on demand
    from (seed, idx), so nothing large is held; 4/9 of max_n to max_n
    events an item, centred as the dataset readers centre them. No
    event-space augmentation."""

    augmentation = False
    num_shots = None

    def __init__(self, n, seed):
        self.n, self.seed = n, seed
        self.classes = [f"class_{i}" for i in range(self.n_classes)]
        self.root = f"synthetic/{seed}"

    def __len__(self):
        return self.n

    def __getitem__(self, idx):
        from eventclip_tpu_torch.data.host_ops import prepare_stream

        rng = np.random.default_rng((self.seed, idx))
        label = int(rng.integers(len(self.classes)))
        n = int(rng.integers(self.max_n * 4 // 9, self.max_n + 1))
        events = synth_events(rng, n, label, *self.resolution, self.max_t)
        return {"events": prepare_stream(events, self.resolution),
                "label": label, "data_idx": idx}


class SyntheticNImageNet(SyntheticEvents):
    """N-ImageNet geometry: 480x640, 1000 classes, 60k-135k events (1 or 2
    windows of N = 70000)."""

    resolution = (480, 640)
    max_t = 0.055
    max_n = 135000
    n_classes = 1000


class SyntheticNCaltech(SyntheticEvents):
    """N-Caltech101 geometry: 180x240, 101 classes, 100k-225k events (5 to
    11 windows of N = 20000; 2 train views, up to 10 at eval)."""

    resolution = (180, 240)
    max_t = 0.3
    max_n = 225000
    n_classes = 101


def leaf_snapshot(params):
    """CPU-side views of a trained and a frozen leaf of each kind (FT: the
    visual tower trains; FS: the adapter)."""
    clip = params.clip
    leaves = {
        "text_feats (trained, prompt tuning)": params.text_feats,
        "text wqkv[0] (frozen)": clip.text.blocks.layers[0].attn.wqkv,
        "logit_scale (frozen)": clip.logit_scale,
    }
    if params.adapter is None:
        leaves.update({
            "visual wqkv[0] (trained)": clip.visual.blocks.layers[0].attn.wqkv,
            "visual proj (trained)": clip.visual.proj})
    else:
        leaves.update({
            "adapter in_proj w (trained)": params.adapter.in_proj.w,
            "adapter wqkv[1] (trained)":
                params.adapter.blocks.layers[1].attn.wqkv,
            "visual wqkv[0] (frozen)": clip.visual.blocks.layers[0].attn.wqkv})
    return leaves


def annotated_ms(prof, label):
    """Device ms of the kernels launched inside `record_function(label)`
    ranges of a profile (forward work only: autograd runs the backward
    outside them), or None where the profile holds no such range."""
    import torch

    evts = [e for e in prof.events() if e.name == label
            and e.device_type == torch.autograd.DeviceType.CPU]
    return sum(e.device_time_total for e in evts) / 1e3 if evts else None


def train_phase(dev, tag="5 train", config=("ftclip",
                                            "ft_text_fsclip_nin_params.py"),
                data=SyntheticNImageNet, n_steps=4, bf16=None, batch=None,
                checkpoint=True, augment=True):
    """Phases 5, 7 and 8 through EventCLIPTrainer on `config` (a path
    under configs/) over `data`. `bf16` (False: f32 end to end) and `batch`
    (train batch; eval twice that) override the loaded config, as a user
    would set them; `augment` False builds the train set without the
    config's img_aug; `checkpoint` adds the moved / frozen leaves and the
    checkpoint round trip."""
    import torch

    from eventclip_tpu_torch import kernels
    from eventclip_tpu_torch.data.event_windows import EventWindowDataset
    from eventclip_tpu_torch.engine.checkpoint import load_checkpoint
    from eventclip_tpu_torch.engine.trainer import EventCLIPTrainer
    from eventclip_tpu_torch.utils.config import load_params

    params = load_params(os.path.join(HERE, "configs", *config))
    cuts = []
    if bf16 is not None:
        params.bf16 = bf16
        cuts.append(f"bf16={bf16}")
    if batch is not None:
        cuts.append(f"train_batch_size {params.train_batch_size} -> {batch},"
                    f" val_batch_size {params.val_batch_size} -> {2 * batch}"
                    " (to keep chip_smoke within its time)")
        params.train_batch_size, params.val_batch_size = batch, 2 * batch
    bs = int(params.train_batch_size)
    q = dict(params.quantize_args)
    img_aug = bool(params.get("img_aug", False)) and augment
    train_set = EventWindowDataset(data(bs * n_steps, seed=1), q,
                                   augment=img_aug)
    val_set = EventWindowDataset(data(int(params.val_batch_size), seed=2),
                                 dict(q, max_imgs=10))
    log(f"[{tag}] {params.model} {params.clip_dict['arch']} "
        f"{params.dataset} {train_set.resolution}, N {train_set.window}, "
        f"views {train_set.max_imgs} (val {val_set.max_imgs}), batch {bs}, "
        f"RandAugment {'on' if img_aug else 'off'} (config img_aug="
        f"{params.get('img_aug')})" + "".join(f"; set on the loaded config: "
                                              f"{c}" for c in cuts))
    out = {}
    with tempfile.TemporaryDirectory() as ckpt_dir:
        t0 = time.perf_counter()
        trainer = EventCLIPTrainer(params, train_set, val_set, ckpt_dir,
                                   smoke=True, seed=0, device=dev)
        cfg = trainer.cls_cfg
        log(f"[{tag}] trainer built in {time.perf_counter() - t0:.1f} s: "
            f"ft_mode {cfg.ft_mode}, adapter {cfg.adapter}, prompt_tuning "
            f"{cfg.prompt_tuning}, dtype {cfg.dtype}, remat {cfg.remat}, "
            f"accum {trainer.accum}, lr groups "
            f"{[g['name'] for g in trainer.optimizer.torch_opt.param_groups]}")
        kernels.reset_launches()
        sanity = trainer.evaluate(max_steps=1)
        log(f"[{tag}] sanity eval (1 batch): launches "
            f"{dict(kernels.LAUNCHES)}")

        before = {k: v.detach().cpu().clone()
                  for k, v in leaf_snapshot(trainer.model_params).items()}
        torch.cuda.reset_peak_memory_stats(dev)
        # the training run: counts zeroed just before, read just after
        kernels.reset_launches()
        stats = trainer.train_epoch(0)
        torch.cuda.synchronize(dev)
        launches = dict(kernels.LAUNCHES)
        peak_gb = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        steps = len(trainer.step_times)
        L = trainer.clip_cfg.vision.layers
        if cfg.model == "FTCLIP":
            want = {"histogram": steps, "qkv_attention": 2 * L * steps,
                    "qkv_attention_bwd": L * steps}
            expect = (f"K1 1, K2 {2 * L} = {L} layers x forward + remat "
                      f"recompute, K3 {L}")
        else:
            want = {"histogram": steps, "qkv_attention": L * steps}
            expect = f"K1 1, K2 {L} = {L} layers x forward, K3 0: frozen tower"
        log(f"[{tag}] launches over the {steps} timed steps {launches} "
            f"(per step: {expect} expected)")
        if launches != want:
            raise AssertionError(f"train launches {launches} != {want}")
        step_ms = [s * 1e3 for _, s in trainer.step_times]
        wait_ms = [w * 1e3 for w, _ in trainer.step_times]
        med = statistics.median(step_ms)
        host_share = sum(wait_ms) / (sum(wait_ms) + sum(step_ms))
        loss = float(stats["total_loss"])
        log(f"[{tag}] steps (ms): {[round(x, 1) for x in step_ms]}; "
            f"median {med:.1f} ms, {bs / (med / 1e3):.1f} samples/s; host "
            f"loader wait {[round(x, 1) for x in wait_ms]} ms, "
            f"{100 * host_share:.1f}% of the epoch's step time; peak memory "
            f"{peak_gb:.2f} GiB; loss {loss:.4f}, train_acc "
            f"{stats['train_acc']:.4f}")
        if not np.isfinite(loss):
            raise AssertionError(f"non-finite training loss {loss}")
        out = dict(step_ms=step_ms, median_step_ms=med,
                   samples_per_s=bs / (med / 1e3), host_wait_ms=wait_ms,
                   host_share=host_share, peak_gib=peak_gb, loss=loss,
                   launches_per_step={k: v // steps
                                      for k, v in launches.items()},
                   sanity_eval=sanity)
        host_batch = next(iter(trainer.train_loader.epoch(1)))
        placed = trainer.device_batch(host_batch)
        out["profile"] = profile_call(f"{tag.split()[0]} profile",
                                      "one train step",
                                      lambda: trainer.train_step(placed))
        if not checkpoint:
            del trainer
            torch.cuda.empty_cache()
            return out, launches
        after = leaf_snapshot(trainer.model_params)
        for name, old in before.items():
            moved = not torch.equal(old, after[name].detach().cpu())
            log(f"[{tag}]   {name}: {'moved' if moved else 'unchanged'}")
            if moved != ("(trained" in name):
                raise AssertionError(f"{name}: moved={moved}")

        val = trainer.evaluate()
        trainer.ckpt.save(trainer.model_params, trainer.optimizer.count, val)
        path = os.path.join(trainer.ckpt.dir, "best.npz")
        trainer.train_step(placed)  # move the trained leaves once more
        load_checkpoint(path, target=trainer.model_params)
        again = trainer.evaluate()
        log(f"[{tag}] checkpoint {os.path.getsize(path) / 2 ** 20:.1f} MiB"
            f" saved, parameters moved by one step, reloaded: eval {val} "
            f"-> {again}")
        for k in val:
            if not np.isclose(val[k], again[k], rtol=1e-6, atol=1e-6):
                raise AssertionError(f"eval after reload: {k} {val[k]} != "
                                     f"{again[k]}")
        out.update(eval=val)
        del trainer
    torch.cuda.empty_cache()
    return out, launches


def every_op_draws(B, num_ops, H, W):
    """[B, num_ops] op indices covering all 14 ops at every step, with
    magnitudes from spread bins, signed ops negated on odd samples."""
    import torch

    from eventclip_tpu_torch.ops.randaugment import OP_NAMES, magnitude_table

    n = len(OP_NAMES)
    b = torch.arange(B)
    op_idx = torch.stack([(b * (2 * i + 1) + i) % n for i in range(num_ops)],
                         1)
    bins = (b * 7) % 30
    mag = magnitude_table(H, W)[op_idx, bins[:, None]]
    return op_idx, torch.where((b % 2 == 1)[:, None], -mag, mag)


def randaugment_card_vs_cpu(dev):
    """RandAugment on the card against the CPU: the same rasterized frames
    (one channel, as grayscale configs run it) and the same draws, every
    op at every step, at phase 5's 480x640 and phase 8's 180x240, held to
    the frame rule: identity, posterize, solarize, autocontrast and
    equalize equal; the rest at most one quantum on under 5e-3 of the
    pixels. Also the card's time at each phase's full batch."""
    import torch

    from eventclip_tpu_torch.ops.randaugment import (GEOMETRIC, OP_NAMES,
                                                     apply_ops,
                                                     magnitude_table,
                                                     sample_ops)
    from eventclip_tpu_torch.ops.rasterize import RasterSpec, rasterize_chw

    exact = {0, 10, 11, 12, 13}
    rows = {}
    gen = torch.Generator(device=dev).manual_seed(5)
    for name, H, W, N, full in (("phase 5", 480, 640, 70000, 128),
                                ("phase 8", 180, 240, 20000, 32)):
        B, T = 28, 2  # each op twice at each step
        wins = synth_windows(gen, B * T, N, H, W, dev).reshape(B, T, N, 3)
        frames = rasterize_chw(RasterSpec(height=H, width=W, window=N),
                               wins)[:, :, :1].contiguous()
        op_idx, mag = every_op_draws(B, 2, H, W)
        card = apply_ops(frames, op_idx.to(dev), mag.to(dev)).cpu()
        cpu = apply_ops(frames.cpu(), op_idx, mag)
        worst = {}
        for b in range(B):
            ops = tuple(op_idx[b].tolist())
            diff = (card[b] - cpu[b]).abs()
            same = all(o in exact for o in ops)
            err, rate = float(diff.max()), float((diff > 0).float().mean())
            key = "+".join(OP_NAMES[o] for o in ops)
            worst[key] = (err, rate)
            if (same and err > 0) or err > 1 or rate >= 5e-3:
                raise AssertionError(
                    f"RandAugment card vs CPU {name} {key}: max |diff| {err},"
                    f" mismatch rate {rate}")
        # the card's time at the phase's full batch of the step's draws
        full_frames = frames.repeat(-(-full // B), 1, 1, 1, 1)[:full]
        draws = sample_ops(gen, full, 2, H, W)
        n_geo = int(sum(o in GEOMETRIC for o in draws[0].reshape(-1).tolist()))
        ms = cuda_ms(lambda: apply_ops(full_frames, *draws), iters=5,
                     warmup=1)
        # one op (at magnitude bin 15) on every frame of the batch, one
        # step: where the time goes
        per_op = {}
        for op in range(len(OP_NAMES)):
            idx = torch.full((full, 1), op, dtype=torch.int64)
            mags = magnitude_table(H, W)[op, 15].expand(full, 1).to(dev)
            per_op[OP_NAMES[op]] = cuda_ms(
                lambda: apply_ops(full_frames, idx, mags), iters=3, warmup=1)
        log(f"[8 RandAugment] one op on all {2 * full} frames at {H}x{W} "
            "(ms): " + ", ".join(f"{k} {v:.2f}" for k, v in per_op.items()))
        rows[name] = dict(
            frames=f"[{full}, 2, 1, {H}, {W}]", ms=ms, per_op_ms=per_op,
            max_abs_err=max(e for e, _ in worst.values()),
            max_mismatch_rate=max(r for _, r in worst.values()))
        log(f"[8 RandAugment] card vs CPU at {H}x{W}, {B} samples x {T} "
            f"views, all 14 ops at both steps: max |diff| "
            f"{rows[name]['max_abs_err']:.0f}, worst mismatch rate "
            f"{rows[name]['max_mismatch_rate']:.2e} (limits: 0 for the "
            f"integer ops, 1 quantum and < 5e-3 for the rest); card "
            f"{ms:.2f} ms for a {name} batch {rows[name]['frames']} "
            f"({n_geo} of {2 * full} sample-steps geometric)")
    return rows


def update_card_vs_cpu(dev, batch_size=4):
    """Phase 6: one FT update of a 2-layer, full-width ViT-L/14 in f32 on
    the card (kernels) and on the CPU (plain versions) from the same
    parameters and batch."""
    import torch

    from eventclip_tpu_torch.data.event_windows import EventWindowDataset
    from eventclip_tpu_torch.data.loader import collate
    from eventclip_tpu_torch.engine.optim import OptimConfig, Optimizer
    from eventclip_tpu_torch.engine.train import make_train_step
    from eventclip_tpu_torch.models.classifier import (
        build_classifier_config, init_classifier_params)
    from eventclip_tpu_torch.models.clip.config import clip_arch_config
    from eventclip_tpu_torch.ops.preprocess import ClipPreprocess
    from eventclip_tpu_torch.utils.config import load_params

    params = load_params(os.path.join(HERE, "configs", "ftclip",
                                      "ft_text_fsclip_nin_params.py"))
    full = clip_arch_config(params.clip_dict["arch"])
    cut = dataclasses.replace(
        full, vision=dataclasses.replace(full.vision, layers=2),
        text=dataclasses.replace(full.text, layers=2))
    cfg = build_classifier_config(params, cut, dtype=torch.float32)
    ds = EventWindowDataset(SyntheticNImageNet(batch_size, seed=3),
                            dict(params.quantize_args))
    host = collate([ds[i] for i in range(batch_size)])
    spec = ds.raster_spec()
    pipeline = (spec, ClipPreprocess(in_height=spec.height,
                                     in_width=spec.width,
                                     image_size=cut.vision.image_size))
    # the shipped clip_lr, no warmup: the first update is at the full rate
    opt_cfg = OptimConfig(lr=float(params.lr), clip_lr=float(params.clip_lr),
                          total_steps=10, warmup_steps_pct=0.0)
    initial = init_classifier_params(
        cfg, torch.Generator().manual_seed(0), n_classes=1000)
    results = {}
    for name, device in (("card", dev), ("cpu", torch.device("cpu"))):
        p = (init_classifier_params(cfg, torch.Generator().manual_seed(0),
                                    n_classes=1000, device="cpu")
             .to(device))
        opt = Optimizer(cfg, opt_cfg, p)
        step = make_train_step(cfg, p, opt, pipeline=pipeline)
        batch = {k: torch.from_numpy(host[k]).to(device)
                 for k in ("windows", "valid_mask", "label")}
        t0 = time.perf_counter()
        metrics = step(batch)
        loss = float(metrics["total_loss"])
        dt = time.perf_counter() - t0
        visual = [(n, q) for n, q in p.named_parameters()
                  if n.startswith("clip.visual.")]
        results[name] = dict(
            loss=loss, s=dt,
            grad=torch.cat([q.grad.detach().cpu().reshape(-1)
                            for _, q in visual]).double(),
            weights=torch.cat([q.detach().cpu().reshape(-1)
                               for _, q in visual]).double())
    before = torch.cat([q.detach().reshape(-1) for n, q in
                        initial.named_parameters()
                        if n.startswith("clip.visual.")]).double()
    a, b = results["card"], results["cpu"]
    cos = float(a["grad"] @ b["grad"]
                / (a["grad"].norm() * b["grad"].norm()))
    grad_rel = float((a["grad"] - b["grad"]).abs().max()
                     / b["grad"].abs().max())
    w_rel = float((a["weights"] - b["weights"]).abs().max()
                  / b["weights"].abs().max())
    moved = float((b["weights"] - before).abs().max())
    log(f"[6 card vs CPU] one FT update, 2-layer ViT-L/14 f32, batch "
        f"{batch_size} x {ds.max_imgs} views: loss card {a['loss']:.6f} / "
        f"CPU {b['loss']:.6f}; visual gradient cosine {cos:.8f}, max |diff| /"
        f" max |grad| {grad_rel:.3g}; updated visual weights max |diff| / "
        f"max |w| {w_rel:.3g} (the update moved them by up to {moved:.3g});"
        f" CPU step {b['s']:.1f} s")
    # Adam's first step moves each weight by about clip_lr * sign(g), so
    # the weights tell only where a noise-level gradient flips its sign:
    # printed, not held; the gradients are the test
    if not (cos >= 0.99999 and grad_rel <= 1e-3):
        raise AssertionError(
            f"card vs CPU update: cosine {cos} (>= 0.99999), gradient "
            f"{grad_rel} (<= 1e-3)")
    return dict(grad_cosine=cos, grad_max_rel=grad_rel,
                weights_max_rel=w_rel)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only",
              file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "eventclip_tpu_torch")):
        print("chip_smoke: eventclip_tpu_torch/ not found beside the script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from eventclip_tpu_torch import kernels
    from eventclip_tpu_torch.models.classifier import compute_text_features
    from eventclip_tpu_torch.models.clip.config import clip_arch_config
    from eventclip_tpu_torch.models.clip.model import init_clip_params
    from eventclip_tpu_torch.serve import Predictor
    from eventclip_tpu_torch.utils.config import load_params

    dev = torch.device("cuda")
    card = gpu_line()
    kind = torch.cuda.get_device_name(0)
    log(f"[1 device] {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    kernels.build_all()
    log(f"[1 device] kernels built in {time.perf_counter() - t0:.1f} s")

    # -- 2 ---------------------------------------------------------------
    gen = torch.Generator(device=dev).manual_seed(0)
    # each path's records at the shapes that path gives the kernel
    rec = {"serve": {}, "train": {}, "train_f32": {}, "train_fs": {},
           "none": {}}
    rec["serve"]["histogram"] = check_histogram(
        gen, "N-Caltech serving", 320, 20000, 180, 240, dev)
    check_histogram(gen, "N-Cars", 32, 30000, 100, 120, dev)
    rec["train"]["histogram"] = check_histogram(
        gen, "N-ImageNet training", 256, 70000, 480, 640, dev)
    rec["train_fs"]["histogram"] = check_histogram(
        gen, "N-Caltech FS training", 64, 20000, 180, 240, dev)
    check_histogram(gen, "720x1280 (row bands)", 32, 70000, 720, 1280, dev)
    check_histogram(gen, "every event on one pixel", 16, 70000, 480, 640,
                    dev, pile=True)
    rec["serve"]["qkv_attention"] = check_attention(
        gen, "ViT-L/14", 320, 257, 16, 64, torch.bfloat16, False, dev)
    text = check_attention(gen, "text ViT-L/14", 101, 77, 12, 64,
                           torch.float32, True, dev)
    check_attention(gen, "ViT-T/8@32", 80, 17, 2, 32, torch.float32, False,
                    dev)
    check_attention(gen, "ViT-T/8@32 bf16", 80, 17, 2, 32, torch.bfloat16,
                    False, dev)
    check_attention(gen, "text ViT-T/8@32", 101, 77, 2, 16, torch.float32,
                    True, dev)
    # f32 at phase 6's width and at ViT-L/14@336's S = 577 (refused before)
    f32 = {f"S={S}": check_attention(gen, f"f32 S={S}", 8, S, 16, 64,
                                     torch.float32, False, dev)
           for S in (257, 577)}
    rec["train"]["qkv_attention"] = check_attention(
        gen, "ViT-L/14 training", 256, 257, 16, 64, torch.bfloat16, False,
        dev)
    # the FS step's frozen tower: 32 samples x 2 views
    rec["train_fs"]["qkv_attention"] = check_attention(
        gen, "ViT-L/14 FS training", 64, 257, 16, 64, torch.bfloat16, False,
        dev)
    rec["train"]["qkv_attention_bwd"] = check_attention_bwd(
        gen, "ViT-L/14 training", 256, 257, 16, 64, torch.bfloat16, False,
        dev)
    f32["bwd text"] = check_attention_bwd(gen, "text ViT-L/14", 101, 77, 12,
                                          64, torch.float32, True, dev)
    check_attention_bwd(gen, "ViT-T/8@32", 80, 17, 2, 32, torch.float32,
                        False, dev)
    check_attention_bwd(gen, "ViT-T/8@32 bf16", 80, 17, 2, 32,
                        torch.bfloat16, False, dev)
    check_attention_bwd(gen, "text ViT-T/8@32", 101, 77, 2, 16,
                        torch.float32, True, dev)
    f32["bwd S=577"] = check_attention_bwd(gen, "f32 S=577", 8, 577, 16, 64,
                                           torch.float32, False, dev)
    # f32 K3 at phase 6's shape, and K2 / K3 at phase 7's f32 FT step
    f32["bwd S=257"] = check_attention_bwd(gen, "f32 S=257", 8, 257, 16, 64,
                                           torch.float32, False, dev)
    rec["train_f32"] = {
        "qkv_attention": check_attention(
            gen, "ViT-L/14 f32 training", 64, 257, 16, 64, torch.float32,
            False, dev),
        "qkv_attention_bwd": check_attention_bwd(
            gen, "ViT-L/14 f32 training", 64, 257, 16, 64, torch.float32,
            False, dev)}
    # bf16 on the tensor-core kernels: the causal mask (the text tower's
    # shape) and ViT-L/14@336's S = 577 (ragged 64-row tiles)
    for name, B, S, heads, causal in (("text ViT-L/14 bf16", 101, 77, 12, True),
                                      ("ViT-L/14@336", 32, 577, 16, False)):
        check_attention(gen, name, B, S, heads, 64, torch.bfloat16, causal,
                        dev)
        check_attention_bwd(gen, name, B, S, heads, 64, torch.bfloat16,
                            causal, dev)
    rec["none"]["attention"] = check_bhsd_attention(
        gen, "ViT-L/14", 320, 257, 16, 64, torch.bfloat16, False, dev)
    check_bhsd_attention(gen, "text, causal", 101, 77, 12, 64, torch.float32,
                         True, dev)
    check_bhsd_attention(gen, "ViT-T/8@32", 80, 17, 2, 32, torch.float32,
                         False, dev)
    orders = check_rounding_orders(gen, 32, 257, 16, 64, dev)

    # -- 3 ---------------------------------------------------------------
    params = load_params(os.path.join(HERE, "configs", "zsclip",
                                      "zsclip_ncaltech_params.py"))
    clip_cfg = clip_arch_config(params.clip_dict["arch"])
    n_cls = 101
    names = [f"class_{i}" for i in range(n_cls)]
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(
        synth_prompts(rng, n_cls, clip_cfg.text.context_length)).to(dev)
    clip = init_clip_params(clip_cfg, torch.Generator(device=dev)
                            .manual_seed(0), device=dev)

    kernels.reset_launches()
    with torch.inference_mode():
        text_feats = compute_text_features(clip, tokens)
    torch.cuda.synchronize()
    text_launches = dict(kernels.LAUNCHES)
    pred = Predictor(params, names, clip_params=clip, text_feats=text_feats,
                     batch_size=32, device=dev)
    log(f"[3 main path] {params.dataset} {clip_cfg.name}: window "
        f"{pred.window}, views {pred.views}, buckets {pred._buckets}; "
        f"text features {tuple(text_feats.shape)} "
        f"(text tower launches {text_launches})")
    kernels.reset_launches()
    t0 = time.perf_counter()
    pred.warm_up()
    log(f"[3 main path] warm-up {time.perf_counter() - t0:.2f} s "
        f"(launches {dict(kernels.LAUNCHES)})")

    requests = [
        ("32 x 225k", [synth_stream(rng, 225000) for _ in range(32)]),
        ("8 x 30-60k", [synth_stream(rng, int(rng.integers(30000, 60001)))
                        for _ in range(8)]),
        ("1 x 5k", [synth_stream(rng, 5000)]),
    ]
    # the main path's run: the counts are zeroed here and read right after
    # the timed requests, so they hold these requests' launches only
    kernels.reset_launches()
    per_request = {}
    for label, streams in requests:
        times, host = [], []
        for _ in range(3):
            before = dict(kernels.LAUNCHES)
            t0 = time.perf_counter()
            wins, valids = pred.gather_windows(streams)
            t1 = time.perf_counter()
            out = pred.predict_windows(wins, valids, top_k=5)
            times.append(time.perf_counter() - t0)
            host.append(t1 - t0)
            check_probs(out, len(streams), n_cls)
        per_req = {k: kernels.LAUNCHES[k] - before.get(k, 0)
                   for k in kernels.LAUNCHES}
        ms = statistics.median(times) * 1e3
        host_ms = statistics.median(host) * 1e3
        per_request[label] = dict(ms=ms, host_ms=host_ms, launches=per_req)
        log(f"[3 main path] request {label}: {ms:.1f} ms median of 3 "
            f"({len(streams) / (ms / 1e3):.2f} streams/s; host windowing "
            f"{host_ms:.1f} ms); launches per request {per_req}; probs "
            "finite, rows sum to 1")
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    log(f"[3 main path] launches over the 9 timed requests {launches}")
    for k in ("histogram", "qkv_attention"):
        if launches.get(k, 0) <= 0:
            raise AssertionError(f"main path never launched the {k} kernel")
    profile_call("3 profile", f"request {requests[0][0]}",
                 lambda: pred.predict(requests[0][1]))

    # -- 4 ---------------------------------------------------------------
    cpu_params = load_params(os.path.join(HERE, "configs", "zsclip",
                                          "zsclip_ncaltech_params.py"))
    cpu_params.bf16 = False
    cpu_pred = Predictor(cpu_params, names, clip_params=clip,
                         text_feats=text_feats.cpu(), batch_size=1,
                         device="cpu")
    wins, valids = pred.gather_windows([synth_stream(rng, 5000)])
    f_gpu = pred._forward(pred._place_chunk(wins, valids))["view_feats"]
    t0 = time.perf_counter()
    f_cpu = cpu_pred._forward(cpu_pred._place_chunk(wins, valids))[
        "view_feats"]
    cpu_s = time.perf_counter() - t0
    a, b = f_gpu[0, 0].double().cpu(), f_cpu[0, 0].double()
    cos = float(a @ b / (a.norm() * b.norm()))
    log(f"[4 card vs CPU] one 5k-event stream: view-feature cosine "
        f"{cos:.6f} (card bf16 vs CPU f32; CPU forward {cpu_s:.1f} s)")
    if not cos >= 0.99:
        raise AssertionError(f"card vs CPU feature cosine {cos} < 0.99")

    # -- 5, 6 ---------------------------------------------------------------
    train, train_launches = train_phase(dev)
    update = update_card_vs_cpu(dev)

    # -- 7 ---------------------------------------------------------------
    train32, train32_launches = train_phase(
        dev, "7 train f32", n_steps=3, bf16=False, batch=32, checkpoint=False,
        augment=False)
    prof = train32["profile"]
    if prof is not None:
        rows = prof.pop("rows")
        k3 = [r for r in rows if "_f32_kernel" in r[2]
              and ("dq_" in r[2] or "dkdv_" in r[2])]
        k3_ms = sum(r[0] for r in k3)
        prof.update(k3_f32_ms=k3_ms, k3_f32_share=k3_ms / prof["busy_ms"])
        log(f"[7 profile] K3 f32 (dq_f32_kernel + dkdv_f32_kernel) in one "
            f"step: {k3_ms:.1f} ms, {100 * k3_ms / prof['busy_ms']:.1f}% of "
            f"the step's device time ({prof['busy_ms']:.1f} ms)")

    # -- 8 ---------------------------------------------------------------
    augment = randaugment_card_vs_cpu(dev)
    train_fs, train_fs_launches = train_phase(
        dev, "8 train FS", config=("fsclip", "joint_adapter",
                                   "joint_fsclip_ncaltech_params.py"),
        data=SyntheticNCaltech)
    for phase in (train, train_fs):
        if phase["profile"] is not None:
            phase["profile"].pop("rows", None)

    sources = {
        "histogram": ("eventclip_tpu_torch/csrc/histogram.cu",
                      "eventclip_tpu/ops/rasterize.py:123"),
        "qkv_attention": ("eventclip_tpu_torch/csrc/attention.cu",
                          "eventclip_tpu/ops/attention.py:325"),
        "qkv_attention_bwd": ("eventclip_tpu_torch/csrc/attention_bwd.cu",
                              "eventclip_tpu/ops/attention.py:215"),
        "attention": ("eventclip_tpu_torch/csrc/attention.cu",
                      "eventclip_tpu/ops/attention.py:115"),
    }
    # each kernel's row: this slice's path, FT training, with launches, ms
    # and bound from that path (K4 is on no path: its own check's shape);
    # by_path holds each path's own row
    counts = {"serve": launches, "train": train_launches,
              "train_f32": train32_launches, "train_fs": train_fs_launches}
    by_path = {p: {k: dict(launches=counts[p].get(k, 0), **r)
                   for k, r in recs.items()}
               for p, recs in rec.items() if p in counts}
    line = {"kernels": [
        dict(name=k, route="cuda", source=src, replaces=tpu,
             launches=train_launches.get(k, 0),
             **(rec["train"].get(k) or rec["none"][k]),
             by_path={p: rows[k] for p, rows in by_path.items() if k in rows})
        for k, (src, tpu) in sources.items()
    ], "text_attention": text, "f32_attention": f32,
        "rounding_orders": orders,
        "requests": per_request, "train": train, "update_card_vs_cpu": update,
        "train_f32": train32, "train_fs": train_fs, "randaugment": augment}
    log(json.dumps(line))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
