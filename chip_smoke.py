#!/usr/bin/env python3
"""Drive the PyTorch port on one card: serving and its options, FT and FS
training, the train / test CLIs and the serve CLI from a dataset tree and
checkpoint files on disk, the ResNet towers, pseudo-labelling with
self-training, the HTTP server and its client, frozen export bundles
(one graph set for the card, one for the CPU), data-parallel training and
pseudo-labelling, the trainer's extras, ZeRO-1, tensor parallelism, and
the converters and real-asset parity harness.

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
   (f32, causal mask; ViT-L/14 and RN50) and tiny-tower
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
9. data to accuracy, in a temporary directory: random ViT-L/14 towers
   saved in fp16 in OpenAI's key layout (a .pt as released), a merge table
   learned from the 101 prompts (EVENTCLIP_BPE_PATH), and an N-Caltech101
   tree of synth_events streams whose training/ holds the files the
   shipped 2-shot split names and testing/ one stream a class. (a)
   cli.test on configs/zsclip/zsclip_ncaltech_params.py with --clip_ckpt:
   the loaded leaf equals the file's, the prompts tokenize to [101, 77],
   counters K2 12 for the text tower and K1 1 / K2 24 per eval batch,
   eval time, samples/s, host-loader wait, finite probabilities; then the
   host's ms an item and a profile of the same eval from the device
   cache. (b)
   cli.train on joint_fsclip_ncaltech_params.py --num_shots 2
   --max_epochs 1: counters K1 1 / K2 24 / K3 0 per step and eval batch,
   ms a step, a best.npz. (c) cli.test --weight best.npz, then the same
   weights exported to the reference's best.pth and found by
   --train_shots 2: equal correct counts. Then K1 and K2 held to their
   plain versions at the eval CLI's first packed batch. The temporary
   directory lives on through phase 10.
10. serving options at ViT-L/14 on phase 3's towers, 101 classes, batch
   32, phase 3's 32 x 225k request: (a) the host half on the numpy and the
   native route (library loaded; prep = copy + polarity remap + crc seed,
   centre, gather: ms each, median of 3), windows and valid masks
   bit-equal, and the native library's calls over phase 3's timed requests
   (one transform and one pack a stream); (b) `int8=True` (dynamic
   scales; every product through torch._int_mm on the card, 97 a request):
   ms a request, device busy ms, agreement with bf16; then static scales
   calibrated on 4 streams, held to the dynamic answer within 0.08 on the
   probabilities; (c) `prune_tokens=128`: ms a request, K1 1 / K2 24,
   device busy ms, K2 held to its plain version at [320, 129, 3072]; (d) `embed=True`: [32,
   768] unit rows, the first 8 embedded alone within the bf16 limit of
   their rows, and the TTA embedding; (e) `set_classes` to 50 names and
   back, through phase 9's merge table: the text tower's K2 12 a swap,
   probabilities back bit for bit; (f) `weight=` phase 9's best.npz and
   its .pth over the testing tree read by `load_event_file` (FS config,
   phase 9's .pt): correct counts equal phase 9(c)'s; (g) a StreamSession
   fed one stream in 10 chunks equals predict on its buffer; (h) `python
   -m eventclip_tpu_torch.serve` in a subprocess: 101 JSONL lines with
   (f)'s labels, then `serve.main` with --embed_out: 101 unit rows.

11. ResNet towers and pseudo-labelling, on phase 9's files: (a) random
   RN50 towers written as OpenAI's fp16 `.pt` (batch-norm statistics
   drawn, folded at load) serve phase 3's 32 x 225k request through
   Predictor (zsclip_ncaltech_params.py with arch RN50: ms a request,
   device busy; K1 1 a request, no K2 in the visual tower, K2 12 for the
   text tower a label set), `cli.test --arch RN50` evaluates phase 9's
   testing split, and one batch of 8 view features is held card (bf16,
   then f32 with TF32 switched on around it) against the CPU's f32; phase
   2 holds K2 at RN50's text shape [101, 77, 1536], 8 heads, f32 causal.
   (b) phase 9's tree gains 2 unlabeled streams a class and cli.gen_data
   labels its training split with three ViT-L/14 teachers: ZS with
   --tta --tta_consistent --tta_min_prob --topk 2; the FS teacher from
   phase 9's best.npz with --weight --gt_shots 2; ZS with --int8
   --int8_calib 1 --prune_tokens 128 (each: samples/s, views/s, loader
   wait, device busy, K1 / K2 a batch, the selection totals; each tree
   checked: every class folder, links to real source files, top-k, the
   GT files merged under their inverted folders). (c) cli.train trains
   the FS student one epoch on the FS teacher's tree (ms a step; K1 1 /
   K2 24 / K3 0 a step) and cli.test evaluates it. (d) cli.gen_data on
   the debug ZS config, then with an RN-T@32 override, f32, on a small
   tree, once on the card and once with --cpu: equal reports and trees.
12. server and export, at ViT-L/14 bf16 on phase 3's predictor and
   request and phase 9's files (it runs after phase 10, before 11, while
   both are at hand): K1 and K2 at the serving shape through their
   custom ops beside their launchers (bit-equal; ms and host us a call).
   (a) the port's HTTP server on an ephemeral port: the 32 x 225k request
   as x-npz through the port's client (median ms of 3 beside the direct
   Predictor.predict; equal labels, names, top-5, probabilities; K1 1 /
   K2 24), 32 concurrent single-stream requests from another process
   with micro-batching on (300 ms cap, 100 ms idle gap) and off
   (streams/s, fused batches, batch_log phases, launches a fused batch),
   a session of 4 appends with predict (ms each; the last equals
   predict on the buffer), /statz. (b) export_predictor with platforms
   cuda and cpu: a graph set traced on the card and one on the CPU
   (padded, 4 packed, text with phase 9's merge table, embed; the graphs
   keep the `eventclip::` ops), the weights once: export s, MB of
   weights and of each set's programs; loaded on the card: load s,
   request ms beside the live one, max prob delta vs live (<= 1e-4),
   launches (K1 1 / K2 24), the embeddings vs the live predictor's
   (<= 1e-4), K1 and K2 device ms a launch inside TRACED_REQUESTS of the
   bundle's requests after a warm-up (torch.profiler; the launches the
   trace holds beside those made), K1 on the request's windows by CUDA
   events, the offline set_classes (reversed names) vs the live swap (<=
   1e-4); loaded on the CPU: load s, one 10-view request (the 80-view
   bucket) against a live CPU predictor on the same leaves (<= 1e-5, no
   launch), the offline swap's text features against the live swap's
   (<= 1e-5), and no graph of the set holding `aten.mm.dtype` or a
   tensor on the card. (c) `python -m eventclip_tpu_torch.export
   --check` in a subprocess (padded programs, the card's set only).
13. data parallelism and the trainer extras at ViT-L/14 (after phase 11,
   in its temp dir): K1, K2 and K3 held to their plain versions at the
   FT shapes of (a). (a) ft_text_fsclip_nin_params.py (bf16, RandAugment,
   batch cut to 32 x 2): 3 steps with no process group, then the same 3
   steps under a one-rank NCCL group (counters zeroed just before, read
   just after: the `ddp` path; K1 1 / K2 48 / K3 24 a step), trained
   leaves bit-equal, ms a step each. (b) joint_fsclip_ncaltech_params.py
   (frozen tower, adapter dropout and RandAugment on, global batch 32)
   on two gloo ranks sharing the card (torch.multiprocessing, spawn):
   after 3 steps the adapter and prompt leaves equal one process on the
   global batch within DDP_FS_ATOL (the key bias and a share
   DDP_FS_SHARE apart), the eval counters summed over the ranks equal
   its eval, rank 1 wrote no file; ms a step a rank. (c) profile_steps 2
   on (a)'s trainer: the trace names K1, K2 and K3's CUDA kernels (MiB,
   write s); run_id on every metrics line; a child process of (b)'s
   trainer sends itself a SIGTERM mid-epoch, ends by it with a
   `preempt` line and a resume.pt (the forced save's s), and the run
   resumed here equals the uninterrupted one bit for bit; the GIFs and
   captions.json of 5 val items (K1 / K2 counted; without PIL the GIFs
   are reported unchecked). (d) phase 11's FS teacher through cli.gen_data
   on two gloo ranks on the card (the JAX triple's env): rank 0's report
   and tree equal phase 11's one-process run, rank 1 prints none.
14. ZeRO-1, tensor parallelism and data-parallel serving (after phase 13,
   in its temp dir): K1, K2 and K3 held to their plain versions at the
   shapes of each path (a tensor-parallel rank's K2 / K3 at [16, 257,
   1536] with 8 heads, also inside each rank). (a)
   ft_text_fsclip_nin_params.py (ViT-L/14, bf16, remat, RandAugment)
   at batch 8 x 2 views: 3 steps in one process, then two gloo ranks on
   the card (NCCL refuses two ranks on one GPU) run it on a 1 x 2
   tensor-parallel layout (counters zeroed just before, read just after,
   on each rank: the `tp` path; K1 1 / K2 48 / K3 24 a step a rank); the
   gathered leaves hold one process's within TP_ATOL_LR / TP_SHARE; ms a
   step and the host collectives' share, parameter bytes a rank. (b) the
   same ranks on 2 data ranks with ZeRO-1 off and on (`zero1` path):
   leaves bit-equal, Adam moment bytes a rank; the ZeRO-1 run's resume.pt
   resumes one process here to its leaves, and that process's next step
   holds the ranks' within the same bound. (c) phase 3's 32 x 225k
   request through Predictor(data_parallel=True): on the one card bit-
   equal to phase 3, and split over [cuda:0, cuda:0] (`dp_serve` path: K1
   once a part) within DP_SERVE_REL of one part's view features; ms a
   request.
15. the port's real-asset parity harness (after phase 14, in its temp
   dir, EVENTCLIP_BPE_PATH unset): cli.parity_check in process on phase
   9's fp16 ViT-L/14 `.pt`, tree and best.pth with the FS config, a
   2-shot run of one epoch and the `.pth` round trip: it returns 0, both
   towers (f32 on the card, TF32 off) within 2e-3 of tests/torch_oracle.py,
   the tokenizer and zero-shot stages skipped with their notes, the method
   eval ok, the round trip bit-equal; each stage's wall s; counters
   zeroed just before and read just after (`parity` path: K1 and K2 run).

Then one JSON line with every kernel's numbers (by_path adds the eval
CLI's `cli` rows, the pruned request's `serve_pruned` K2 row, RN50's
text-tower `rn50` K2 row and the bundle's `export` rows, timed by the
profiler inside its request, phase 13(a)'s `ddp` rows, phase 14's
`tp`, `zero1` and `dp_serve` rows and phase 15's `parity` rows (the eval
CLI's shapes); `eval_cli`, `train_cli` and `trained_eval` hold phase 9,
`serve_options` phase 10, `pseudo_labels` phase 11, `server_export`
phase 12, `ddp` phase 13, `parallel` phase 14, `parity` phase 15),
the
card's name and power limit, and as the last line
{"ok": true, "device": {...}}. Imports nothing
of JAX. Fails when no CUDA device is present or the port is missing.
"""

from __future__ import annotations

import dataclasses
import gzip
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
# int8 (W8A8) vs bf16 at ViT-L/14: what the 24 blocks add to a view's
# tokens, norm-relative (phase 10(b)): twice the dynamic route's worst
# view as measured on an H100 (see PERF.md); on a ViT-T/8@32 tower a
# wrong scale or a shuffled code order gave 0.47-1.34
INT8_BLOCKS_REL = {"dynamic": 0.06, "calibrated": 0.06}


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
# 12(b): the bundle's requests traced for its kernel rows, after one
# untraced warm-up request, each in a range of this name (a span on the
# device, not kernel time)
TRACED_REQUESTS = 6
REQUEST_RANGE = "bundle request"


def profile_call(tag, label, fn, keep=False):
    """Device time by kernel over one call of fn() (torch.profiler), and
    the device's busy share of the call's wall time; returns the wall and
    busy ms, every (ms, count, name) kernel row, and for each RANGES range
    in the call its kernels' ms and its span on the device (with `keep`,
    also the profiler itself, under "prof")."""
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
        if evt.key in RANGES or evt.key.startswith(REQUEST_RANGE):
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
    out = dict(wall_ms=wall_ms, busy_ms=busy, rows=rows, ranges=ranges)
    if keep:
        out["prof"] = prof
    return out


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


# -- phase 9: data to accuracy -------------------------------------------------


def openai_state_dict(clip, dtype=None, bn_seed=0):
    """The port's CLIP towers -> a state dict in OpenAI's key layout (the
    released checkpoints' names), optionally cast to `dtype` (the releases
    are fp16). The inverse of models/clip/convert.py's key map; the port
    itself never writes this layout. A ResNet tower's folded batch norms
    get running statistics drawn from `bn_seed` (mean N(0, 0.1²), var
    U(0.5, 1.5)) and the weight / bias that fold back to the tower's
    scale / bias."""
    import torch

    from eventclip_tpu_torch.models.clip.resnet import ResNetVisionTower

    v, t = clip.visual, clip.text
    sd = {
        "token_embedding.weight": t.token_embedding,
        "positional_embedding": t.positional_embedding,
        "ln_final.weight": t.ln_final.weight,
        "ln_final.bias": t.ln_final.bias,
        "text_projection": t.projection,
        "logit_scale": clip.logit_scale,
    }
    towers = [("transformer.resblocks", t)]
    if isinstance(v, ResNetVisionTower):
        sd.update(resnet_openai_state_dict(v, bn_seed))
    else:
        ps = v.cfg.patch_size
        sd.update({
            "visual.conv1.weight": v.patch_embed.reshape(-1, 3, ps, ps),
            "visual.class_embedding": v.class_embedding,
            "visual.positional_embedding": v.positional_embedding,
            "visual.ln_pre.weight": v.ln_pre.weight,
            "visual.ln_pre.bias": v.ln_pre.bias,
            "visual.ln_post.weight": v.ln_post.weight,
            "visual.ln_post.bias": v.ln_post.bias,
            "visual.proj": v.proj,
        })
        towers.append(("visual.transformer.resblocks", v))
    for prefix, tower in towers:
        for i, blk in enumerate(tower.blocks.layers):
            pre = f"{prefix}.{i}"
            sd.update({
                f"{pre}.attn.in_proj_weight": blk.attn.wqkv,
                f"{pre}.attn.in_proj_bias": blk.attn.bqkv,
                f"{pre}.attn.out_proj.weight": blk.attn.wo,
                f"{pre}.attn.out_proj.bias": blk.attn.bo,
                f"{pre}.ln_1.weight": blk.ln_1.weight,
                f"{pre}.ln_1.bias": blk.ln_1.bias,
                f"{pre}.ln_2.weight": blk.ln_2.weight,
                f"{pre}.ln_2.bias": blk.ln_2.bias,
                f"{pre}.mlp.c_fc.weight": blk.mlp.w1,
                f"{pre}.mlp.c_fc.bias": blk.mlp.b1,
                f"{pre}.mlp.c_proj.weight": blk.mlp.w2,
                f"{pre}.mlp.c_proj.bias": blk.mlp.b2,
            })
    with torch.no_grad():
        return {k: x.detach().to(
                    "cpu", (dtype or x.dtype) if x.is_floating_point()
                    else x.dtype).clone()
                for k, x in sd.items()}


def resnet_openai_state_dict(v, bn_seed=0):
    """A port ResNet tower -> OpenAI's `visual.*` keys (unfolded batch
    norms with drawn running statistics, `num_batches_tracked` as torch
    writes it)."""
    import torch

    gen = torch.Generator().manual_seed(bn_seed)
    sd = {}

    def bn(prefix, affine, eps=1e-5):
        scale = affine.weight.detach().float().cpu()
        shift = affine.bias.detach().float().cpu()
        mean = torch.randn(scale.shape, generator=gen) * 0.1
        var = torch.rand(scale.shape, generator=gen) + 0.5
        sd.update({f"{prefix}.weight": scale * torch.sqrt(var + eps),
                   f"{prefix}.bias": shift + mean * scale,
                   f"{prefix}.running_mean": mean,
                   f"{prefix}.running_var": var,
                   f"{prefix}.num_batches_tracked": torch.tensor(0)})

    def convs(pre, m):
        for i in (1, 2, 3):
            sd[f"{pre}.conv{i}.weight"] = getattr(m, f"conv{i}")
            bn(f"{pre}.bn{i}", getattr(m, f"bn{i}"))

    convs("visual", v.stem)
    for s in range(1, 5):
        stage = getattr(v, f"layer{s}")
        blocks = [stage.block0] + (list(stage.rest.layers)
                                   if stage.rest is not None else [])
        for i, blk in enumerate(blocks):
            pre = f"visual.layer{s}.{i}"
            convs(pre, blk)
            if blk.downsample is not None:
                sd[f"{pre}.downsample.0.weight"] = blk.downsample.conv
                bn(f"{pre}.downsample.1", blk.downsample.bn)
    pool = v.attnpool
    sd["visual.attnpool.positional_embedding"] = pool.positional_embedding
    for name in ("q_proj", "k_proj", "v_proj", "c_proj"):
        sd[f"visual.attnpool.{name}.weight"] = getattr(pool, name).w
        sd[f"visual.attnpool.{name}.bias"] = getattr(pool, name).b
    return sd


def synth_merges(texts, n):
    """A BPE merge table learned from `texts` (at most `n` merges, each the
    most frequent adjacent pair, ties by order), as the released vocab
    file's text: a version line, then one merge a line."""
    from collections import Counter

    words = Counter(tuple(w[:-1]) + (w[-1] + "</w>",)
                    for t in texts for w in t.lower().split())
    merges = []
    while len(merges) < n:
        pairs = Counter()
        for word, count in words.items():
            for pair in zip(word[:-1], word[1:]):
                pairs[pair] += count
        if not pairs:
            break
        best = max(sorted(pairs), key=pairs.__getitem__)
        merges.append(best)
        merged = Counter()
        for word, count in words.items():
            out, i = [], 0
            while i < len(word):
                if word[i:i + 2] == best:
                    out.append(best[0] + best[1])
                    i += 2
                else:
                    out.append(word[i])
                    i += 1
            merged[tuple(out)] += count
        words = merged
    return "#version: 0.2\n" + "\n".join(" ".join(m) for m in merges) + "\n"


def write_ncaltech_tree(root, seed):
    """An N-Caltech101 tree of synth_events streams (100k-225k events, made
    from (seed, file index)): training/ holds exactly the files the shipped
    2-shot split names, testing/ one stream a class for the 101 classes."""
    from eventclip_tpu_torch.data.datasets import load_split_asset

    split = load_split_asset("NCaltech101", 2, True)
    classes = sorted({rel.split("/")[-2] for rel in split})
    files = [(os.path.join("training", *rel.split("/")[-2:]), label)
             for rel, label in split.items()]
    files += [(os.path.join("testing", c, f"{c}_0.npy"), i)
              for i, c in enumerate(classes)]
    for i, (rel, label) in enumerate(files):
        rng = np.random.default_rng((seed, i))
        path = os.path.join(root, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        np.save(path, synth_events(rng, int(rng.integers(100000, 225001)),
                                   label, 180, 240, 0.3))
    return classes, len(files)


def data_to_accuracy(dev, gen, tmp):
    """Phase 9: a ViT-L/14 checkpoint, a merge table and an N-Caltech tree
    on disk in `tmp`, then (a) zero-shot eval through cli.test, (b) FS
    training through cli.train, (c) the trained checkpoint evaluated
    through cli.test as .npz and, exported, as the reference's .pth.
    Returns the phase's record, the eval CLI's kernel rows (K1 and K2 at
    its first batch's packed shape) and the files phase 10 serves from;
    the merge table stays on EVENTCLIP_BPE_PATH for phase 10."""
    import shutil

    import torch

    from eventclip_tpu_torch import kernels
    from eventclip_tpu_torch.cli import test as cli_test
    from eventclip_tpu_torch.cli import train as cli_train
    from eventclip_tpu_torch.engine.checkpoint import load_checkpoint
    from eventclip_tpu_torch.models.classifier import (
        classifier_forward_packed, tokenize_prompts)
    from eventclip_tpu_torch.models.clip.config import clip_arch_config
    from eventclip_tpu_torch.models.clip.convert_method import (
        save_method_checkpoint, unflatten)
    from eventclip_tpu_torch.models.clip.model import init_clip_params
    from eventclip_tpu_torch.models.clip.tokenizer import SimpleTokenizer
    from eventclip_tpu_torch.ops.rasterize import rasterize_for_clip
    from eventclip_tpu_torch.utils.config import load_params

    tag = "9 data"
    t_phase = time.perf_counter()
    zs = os.path.join(HERE, "configs", "zsclip", "zsclip_ncaltech_params.py")
    fs = os.path.join(HERE, "configs", "fsclip", "joint_adapter",
                      "joint_fsclip_ncaltech_params.py")
    clip_cfg = clip_arch_config(load_params(zs).clip_dict["arch"])
    L, Lt = clip_cfg.vision.layers, clip_cfg.text.layers
    out = {}
    t0 = time.perf_counter()
    clip = init_clip_params(clip_cfg, torch.Generator(device=dev)
                            .manual_seed(9), device=dev)
    sd = openai_state_dict(clip, torch.float16)  # fp16, as released
    del clip
    pt = os.path.join(tmp, "ViT-L-14.pt")
    torch.save(sd, pt)
    tree = os.path.join(tmp, "N-Caltech101")
    classes, n_files = write_ncaltech_tree(tree, seed=9)
    prompt = load_params(zs).clip_dict["prompt"]
    vocab = os.path.join(tmp, "bpe_simple_vocab_16e6.txt.gz")
    with gzip.open(vocab, "wt", encoding="utf-8") as f:
        f.write(synth_merges([prompt.format(c.lower().replace("_", " "))
                              for c in classes], 400))
    os.environ["EVENTCLIP_BPE_PATH"] = vocab
    tok = SimpleTokenizer()
    log(f"[{tag}] inputs in {time.perf_counter() - t0:.1f} s: "
        f"{clip_cfg.name} random towers saved in fp16 in OpenAI's key "
        f"layout ({os.path.getsize(pt) / 2 ** 30:.2f} GiB), a merge "
        f"table of {len(tok.bpe_ranks)} merges, an N-Caltech101 tree of "
        f"{n_files} streams (training/: the shipped 2-shot split's 202 "
        "files; testing/: one a class)")

    # (a) zero-shot evaluation through the test CLI: the counts are
    # zeroed just before and read just after
    kernels.reset_launches()
    res = cli_test.main(["--params", zs, "--clip_ckpt", pt,
                         "--data_root", tree])
    torch.cuda.synchronize(dev)
    launches = dict(kernels.LAUNCHES)
    ctx = res["ctx"]
    ev = ctx["evals"][-1]
    b = ev["batches"]
    want = {"histogram": b, "qkv_attention": Lt + L * b}
    log(f"[{tag}] (a) eval CLI launches {launches}: K2 {Lt} for the text "
        f"tower, then K1 1 / K2 {L} per eval batch over {b} batches")
    if launches != want:
        raise AssertionError(f"eval CLI launches {launches} != {want}")
    params = ctx["template"]
    exact = torch.equal(
        params.clip.visual.blocks.layers[0].attn.wqkv.detach().cpu(),
        sd["visual.transformer.resblocks.0.attn.in_proj_weight"].float())
    if not exact:
        raise AssertionError("loaded visual wqkv[0] differs from the "
                             "file's fp16 values cast to f32")
    names = ctx["loader"].dataset.classes
    tokens = tokenize_prompts(names, prompt, tok,
                              clip_cfg.text.context_length)
    if tokens.shape != (len(classes), clip_cfg.text.context_length):
        raise AssertionError(f"prompt tokens {tokens.shape}")
    views = [(int(d["valid_mask"].sum()), int(d["windows"].shape[0]))
             for d in ctx["dev_batches"]]
    first = ctx["dev_batches"][0]
    spec, pp = ctx["raster"]
    with torch.inference_mode():
        probs = classifier_forward_packed(
            params, ctx["cls_cfg"],
            rasterize_for_clip(spec, pp, first["windows"]),
            first["view_src"], first["valid_mask"])["probs"]
    if not (torch.isfinite(probs).all() and 0 <= res["probs_acc"] <= 1
            and 0 <= res["logits_acc"] <= 1):
        raise AssertionError("non-finite probabilities or accuracies "
                             "outside [0, 1]")
    shapes = {"histogram": tuple(first["windows"].shape),
              "qkv_attention": (first["windows"].shape[0],
                                clip_cfg.vision.seq_len,
                                3 * clip_cfg.vision.width)}
    log(f"[{tag}] (a) CLIP .pt loaded in {ctx['timing']['clip_s']:.2f} "
        "s; visual wqkv[0] equals the file's fp16 values cast to f32 "
        f"exactly; prompt tokens {tokens.shape} through the port's "
        f"tokenizer; text features in "
        f"{ctx['timing']['text_feats_s'] * 1e3:.1f} ms; eval of "
        f"{int(ev['n'])} samples in {ev['wall_s']:.2f} s "
        f"({ev['n'] / ev['wall_s']:.1f} samples/s; host loader wait "
        f"{ev['wait_s']:.2f} s, {100 * ev['wait_s'] / ev['wall_s']:.1f}%"
        f"); views per batch (real, packed) {views}; probs "
        f"finite; accuracy probs {res['probs_acc']:.4f} / logits "
        f"{res['logits_acc']:.4f} (random towers: chance, measures "
        "nothing)")
    # where the eval's time goes: the host's work an item (np.load,
    # centring, windowing; the loader spreads it over its threads),
    # and the card's on the same batches from the device cache
    val_set = ctx["loader"].dataset
    t0 = time.perf_counter()
    for i in range(len(val_set)):
        val_set[i]
    item_ms = (time.perf_counter() - t0) * 1e3 / len(val_set)
    log(f"[{tag}] (a) host: {item_ms:.1f} ms an item (np.load, "
        f"centring, windowing; {len(val_set)} items, one thread; the "
        f"loader runs {ctx['loader'].num_workers} threads)")
    args = cli_test.parse_args(["--params", zs, "--data_root", tree])
    zs_params, _ = cli_test.load_and_override(args)
    prof = profile_call(f"{tag} profile", "eval from the device cache",
                        lambda: cli_test.evaluate(zs_params, args,
                                                  printing=False,
                                                  ctx=ctx))
    if prof is not None:
        prof.pop("rows")
    out["eval_cli"] = dict(
        host_item_ms=item_ms, profile=prof,
        clip_load_s=ctx["timing"]["clip_s"],
        text_feats_ms=ctx["timing"]["text_feats_s"] * 1e3,
        tokens=list(tokens.shape), views=views, wall_s=ev["wall_s"],
        samples_per_s=ev["n"] / ev["wall_s"], host_wait_s=ev["wait_s"],
        batches=b, n=ev["n"], launches=launches,
        first_batch=shapes, probs_acc=res["probs_acc"],
        logits_acc=res["logits_acc"])
    del ctx, res, params, first, probs
    torch.cuda.empty_cache()

    # (b) few-shot training through the train CLI
    base = os.path.join(tmp, "checkpoint")
    kernels.reset_launches()
    t0 = time.perf_counter()
    trainer = cli_train.main([
        "--params", fs, "--num_shots", "2", "--max_epochs", "1",
        "--clip_ckpt", pt, "--data_root", tree, "--ckpt_base", base])
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    steps = len(trainer.step_times)
    evals = min(2, len(trainer.val_loader)) + len(trainer.val_loader)
    # the validation GIFs' forwards (K1 + K2 each) and inputs (K1 each)
    vp, vi = trainer.viz_forwards
    want = {"histogram": steps + evals + vp + vi,
            "qkv_attention": Lt + L * (steps + evals + vp)}
    log(f"[{tag}] (b) train CLI launches {launches}: K2 {Lt} for the "
        f"text tower, then K1 1 / K2 {L} / K3 0 per train step and per "
        f"eval batch ({steps} steps, {evals} eval batches), and the "
        f"validation GIFs' {vp} forwards + {vi} input frames")
    if launches != want:
        raise AssertionError(f"train CLI launches {launches} != {want}")
    step_ms = [s * 1e3 for _, s in trainer.step_times]
    wait_ms = [w * 1e3 for w, _ in trainer.step_times]
    med = statistics.median(step_ms)
    bs = trainer.global_batch
    models = os.path.join(base, "joint_fsclip_ncaltech_params-2shot",
                          "models")
    best = os.path.join(models, "best.npz")
    if not os.path.exists(best):
        raise AssertionError(f"no {best}")
    log(f"[{tag}] (b) {len(trainer.train_set)} training samples, "
        f"{steps} steps (ms): {[round(x, 1) for x in step_ms]}; median "
        f"{med:.1f} ms, {bs / (med / 1e3):.1f} samples/s; host loader "
        f"wait {[round(x, 1) for x in wait_ms]} ms; CLI wall "
        f"{wall:.1f} s; best.npz written")
    out["train_cli"] = dict(
        steps=steps, step_ms=step_ms, median_step_ms=med,
        samples_per_s=bs / (med / 1e3), host_wait_ms=wait_ms,
        wall_s=wall, launches=launches,
        launches_per_step={"histogram": 1, "qkv_attention": L,
                           "qkv_attention_bwd": 0})
    del trainer
    torch.cuda.empty_cache()

    # (c) the trained weights as .npz, then as the reference's .pth
    argv = ["--params", fs, "--clip_ckpt", pt, "--data_root", tree]
    npz = cli_test.main(argv + ["--weight", best])["ctx"]["evals"][-1]
    flat, _ = load_checkpoint(best)
    save_method_checkpoint(os.path.join(models, "best.pth"),
                           unflatten(flat))
    shutil.move(best, os.path.join(tmp, "best.npz"))
    pth = cli_test.main(argv + ["--train_shots", "2", "--ckpt_base",
                                base])["ctx"]["evals"][-1]
    keys = ("n", "probs_correct", "logits_correct")
    log(f"[{tag}] (c) trained checkpoint as .npz: "
        f"{ {k: npz[k] for k in keys} }; as the exported .pth through "
        f"--train_shots 2 ({os.path.basename(pth['weight'])}): "
        f"{ {k: pth[k] for k in keys} }")
    if not pth["weight"].endswith("best.pth") or any(
            npz[k] != pth[k] for k in keys):
        raise AssertionError(f"npz {npz} vs pth {pth}")
    out["trained_eval"] = {k: npz[k] for k in keys}
    files = dict(pt=pt, tree=tree, fs=fs, classes=classes,
                 npz=os.path.join(tmp, "best.npz"),
                 pth=os.path.join(models, "best.pth"))
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[{tag}] phase 9 in {out['phase_s']:.1f} s")

    rows = {"histogram": check_histogram(gen, "N-Caltech eval CLI",
                                         *shapes["histogram"][:2], 180, 240,
                                         dev),
            "qkv_attention": check_attention(
                gen, "ViT-L/14 eval CLI", shapes["qkv_attention"][0],
                clip_cfg.vision.seq_len, clip_cfg.vision.heads,
                clip_cfg.vision.width // clip_cfg.vision.heads,
                torch.bfloat16, False, dev)}
    return out, rows, files


# -- phase 10: serving options ------------------------------------------------


def host_split(pred, streams):
    """One request's host half by stage, on the current host-ops route:
    prep (copy, polarity remap, crc seed), centre (prepare_stream) and
    gather (windows, int16 packing); returns the ms of each and the
    stacked windows and valid masks."""
    from eventclip_tpu_torch.data.host_ops import (gather_event_windows,
                                                   prepare_stream)

    ms = {"prep": 0.0, "center": 0.0, "gather": 0.0}
    wins, valids = [], []
    for s in streams:
        t0 = time.perf_counter()
        ev, rng = pred._canonical(s)
        t1 = time.perf_counter()
        ev = prepare_stream(ev, pred.resolution)
        t2 = time.perf_counter()
        w, v = gather_event_windows(ev, pred.window, pred.views, rng=rng,
                                    packed=True)
        t3 = time.perf_counter()
        ms["prep"] += (t1 - t0) * 1e3
        ms["center"] += (t2 - t1) * 1e3
        ms["gather"] += (t3 - t2) * 1e3
        wins.append(w)
        valids.append(v)
    return ms, np.stack(wins), np.stack(valids)


def timed_requests(pred, streams, n=3):
    """Median ms of n requests (host windowing + device, ending in the
    probabilities on the host), the kernel launches of one, the output."""
    import torch

    from eventclip_tpu_torch import kernels

    times = []
    for _ in range(n):
        kernels.reset_launches()
        t0 = time.perf_counter()
        out = pred.predict(streams)
        times.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return statistics.median(times) * 1e3, dict(kernels.LAUNCHES), out


def blocks_delta(pred, streams):
    """What the visual tower's blocks add to the tokens of one request
    (their output less their input), f32 [views, S, D], read through
    pred.predict. Random towers map every stream to nearly one feature, so
    the probabilities and features cannot tell a right tower from a wrong
    one; this can."""
    import torch

    seen = []
    hook = pred._params.clip.visual.blocks.register_forward_hook(
        lambda m, args, out: seen.append(out.float() - args[0].float()))
    try:
        pred.predict(streams)
    finally:
        hook.remove()
    return torch.cat(seen)


def serving_options(dev, gen, pred, clip, text_feats, names, streams,
                    native_calls, files, trained_eval):
    """Phase 10: the serving options at ViT-L/14 on phase 3's towers and
    request (32 x 225k events), phase 9's files for weight= and the CLI.
    Returns the phase's record, the pruned path's K2 row and its
    launches."""
    import glob

    import torch

    from eventclip_tpu_torch import kernels, native
    from eventclip_tpu_torch.ops import quant
    from eventclip_tpu_torch.serve import (Predictor, StreamSession,
                                           load_event_file,
                                           resolve_class_names)
    from eventclip_tpu_torch.serve import main as serve_main
    from eventclip_tpu_torch.utils.config import load_params

    tag = "10 serve options"
    t_phase = time.perf_counter()
    zs = os.path.join(HERE, "configs", "zsclip", "zsclip_ncaltech_params.py")
    out = {}

    def build(**kw):
        p = Predictor(load_params(zs), names, clip_params=clip,
                      text_feats=text_feats, batch_size=32, device=dev, **kw)
        p.warm_up()
        return p

    # (a) the host half on both routes, same request
    if not native.available():
        raise AssertionError("the native host-ops library did not load: "
                             f"{native.load_error()}")
    split = {}
    for route, env in (("numpy", "0"), ("native", "1")):
        os.environ["EVENTCLIP_NATIVE"] = env
        native.reset_for_tests()
        if native.available() != (route == "native"):
            raise AssertionError(f"EVENTCLIP_NATIVE={env} did not switch "
                                 "the host-ops route")
        runs = [host_split(pred, streams) for _ in range(3)]
        split[route] = {k: statistics.median(r[0][k] for r in runs)
                        for k in ("prep", "center", "gather")}
        split[route]["total"] = sum(split[route].values())
        split[route]["windows"] = runs[0][1:]
        want = pred.gather_windows(streams)
        for got, ref in zip(runs[0][1:], want):
            if not np.array_equal(got, ref):
                raise AssertionError(f"{route}: stage-timed windows differ "
                                     "from gather_windows")
    os.environ.pop("EVENTCLIP_NATIVE")
    native.reset_for_tests()
    if not native.available():
        raise AssertionError("the native library did not load again: "
                             f"{native.load_error()}")
    equal = all(np.array_equal(a, b) for a, b in
                zip(split["numpy"].pop("windows"),
                    split["native"].pop("windows")))
    if not equal:
        raise AssertionError("native and numpy windows / valid masks differ")
    want_calls = {"transform": 3 * 41, "pack_spans": 3 * 41}
    log(f"[{tag}] (a) host windowing of the 32 x 225k request, median of 3 "
        f"(ms): numpy {split['numpy']}, native {split['native']}; windows "
        f"and valid masks bit-equal; native calls over phase 3's 9 timed "
        f"requests {native_calls} (123 streams)")
    if native_calls != want_calls:
        raise AssertionError(f"native calls {native_calls} != {want_calls}")
    out["host_split_ms"] = split
    out["native_calls_phase3"] = native_calls

    base = pred.predict(streams)
    # (b) int8: dynamic scales, then static from 4 streams
    int_mm = {"calls": 0, "on_card": True}
    orig_int_mm = quant._int_mm

    def counted_int_mm(a, b):
        int_mm["calls"] += 1
        int_mm["on_card"] &= a.device.type == b.device.type == dev.type
        return orig_int_mm(a, b)

    quant._int_mm = counted_int_mm
    try:
        q8 = build(int8=True)
        int_mm["calls"] = 0
        ms, launches, dyn = timed_requests(q8, streams)
        per_forward = int_mm["calls"] / 3
        prof = profile_call(f"{tag} profile", "int8 request",
                            lambda: q8.predict(streams))
        if prof is not None:
            prof.pop("rows")
        # the blocks' contribution to the request's tokens, int8 vs bf16
        d8, d16 = blocks_delta(q8, streams), blocks_delta(pred, streams)
        del q8
        cal = build(int8=True, int8_calib_streams=streams[:4])
        stat = cal.predict(streams)
        dcal = blocks_delta(cal, streams)
        del cal
    finally:
        quant._int_mm = orig_int_mm
    torch.cuda.empty_cache()
    check_probs(dyn, len(streams), len(names))
    agree = float((dyn["label"] == base["label"]).mean())
    dprob = float(np.abs(dyn["probs"] - base["probs"]).max())
    dstat = float(np.abs(stat["probs"] - dyn["probs"]).max())
    rel8 = {}
    for mode, d in (("dynamic", d8), ("calibrated", dcal)):
        per_view = (d - d16).flatten(1).norm(dim=1) / d16.flatten(1).norm(
            dim=1)
        rel8[mode] = dict(request=float((d - d16).norm() / d16.norm()),
                          worst_view=float(per_view.max()))
    del d8, dcal, d16
    log(f"[{tag}] (b) int8 (dynamic): {ms:.1f} ms a request, median of 3; "
        f"launches {launches}; torch._int_mm {per_forward:.0f} calls a "
        f"request, all on the card: {int_mm['on_card']}; device busy "
        + ("not measured" if prof is None else f"{prof['busy_ms']:.1f} ms "
           f"of {prof['wall_ms']:.1f}") + f"; vs bf16: argmax equal "
        f"{agree:.4f}, max |dprob| {dprob:.3g}; the blocks' contribution "
        f"to the tokens vs bf16, norm-relative over the request and the "
        f"worst view (limit {INT8_BLOCKS_REL}): {rel8}; calibrated on 4 "
        f"streams: "
        f"max |dprob| vs dynamic {dstat:.3g} (limit 0.08)")
    want = 1 + 4 * clip.cfg.vision.layers  # patch_embed + 4 a block
    if not int_mm["on_card"] or per_forward != want:
        raise AssertionError(f"int8 products {int_mm}: want {want} a "
                             "request, on the card")
    if not dstat <= 0.08:
        raise AssertionError(f"calibrated int8 vs dynamic {dstat} > 0.08")
    for mode, r in rel8.items():
        if not r["worst_view"] <= INT8_BLOCKS_REL[mode]:
            raise AssertionError(f"int8 ({mode}) blocks vs bf16: {r} > "
                                 f"{INT8_BLOCKS_REL[mode]} norm-relative")
    out["int8"] = dict(ms=ms, launches=launches, profile=prof,
                       int_mm_per_request=per_forward, argmax_equal=agree,
                       max_dprob_vs_bf16=dprob, blocks_rel_vs_bf16=rel8,
                       calibrated_max_dprob_vs_dynamic=dstat)

    # (c) pruning: 128 of 256 patches a view
    pr = build(prune_tokens=128)
    ms, pruned_launches, pout = timed_requests(pr, streams)
    check_probs(pout, len(streams), len(names))
    pprof = profile_call(f"{tag} profile", "pruned request",
                         lambda: pr.predict(streams))
    if pprof is not None:
        pprof.pop("rows")
    del pr
    torch.cuda.empty_cache()
    want = {"histogram": 1, "qkv_attention": clip.cfg.vision.layers}
    log(f"[{tag}] (c) pruned to 128 tokens: {ms:.1f} ms a request, median "
        f"of 3; launches {pruned_launches}; vs bf16 argmax equal "
        f"{float((pout['label'] == base['label']).mean()):.4f}")
    if pruned_launches != want:
        raise AssertionError(f"pruned launches {pruned_launches} != {want}")
    row = check_attention(gen, "ViT-L/14 pruned 128", 320, 129, 16, 64,
                          torch.bfloat16, False, dev)
    out["pruned"] = dict(ms=ms, launches=pruned_launches, profile=pprof)

    # (d) embeddings, plain and TTA
    em = build(embed=True)
    f32 = em.embed(streams)
    f8 = em.embed(streams[:8])
    norms = np.linalg.norm(f32, axis=-1)
    d8 = float(np.abs(f8 - f32[:8]).max())
    em.tta = True
    ftta = em.embed(streams[:8])
    em.tta = False
    log(f"[{tag}] (d) embed: {f32.shape}, norms {norms.min():.6f}.."
        f"{norms.max():.6f}; the first 8 alone vs in the 32: max |d| "
        f"{d8:.3g} (limit {ATOL['bfloat16']}); TTA {ftta.shape}, norms "
        f"{np.linalg.norm(ftta, axis=-1).min():.6f}")
    if f32.shape != (32, clip.cfg.embed_dim) or not np.allclose(
            norms, 1.0, atol=1e-4) or not d8 <= ATOL["bfloat16"]:
        raise AssertionError("embeddings: shape, norm or batch invariance")
    if ftta.shape != (8, clip.cfg.embed_dim) or not np.allclose(
            np.linalg.norm(ftta, axis=-1), 1.0, atol=1e-4):
        raise AssertionError("TTA embeddings: shape or norm")
    out["embed"] = dict(shape=list(f32.shape), first8_max_diff=d8)

    # (e) label swaps through the tokenizer (phase 9's merge table)
    few = streams[:8]
    kernels.reset_launches()
    em.set_classes(names)
    torch.cuda.synchronize()
    text_launches = dict(kernels.LAUNCHES)
    p0 = em.predict(few)["probs"]
    em.set_classes(names[:50])
    p50 = em.predict(few)["probs"]
    em.set_classes(names)
    p1 = em.predict(few)["probs"]
    log(f"[{tag}] (e) set_classes: text tower launches {text_launches} a "
        f"swap; {p0.shape} -> {p50.shape} -> {p1.shape}; back to the "
        f"original names bit for bit: {np.array_equal(p0, p1)}")
    if p50.shape != (8, 50) or not np.array_equal(p0, p1):
        raise AssertionError("set_classes: shape, or the swap back changed "
                             "the probabilities")
    if text_launches != {"qkv_attention": clip.cfg.text.layers}:
        raise AssertionError(f"text tower launches {text_launches}")
    out["set_classes"] = dict(text_launches=text_launches)

    # (g) StreamSession: one stream in 10 chunks
    sess = StreamSession(pred)
    for chunk in np.array_split(streams[0], 10):
        sess.append(chunk)
    rolling = sess.predict()
    direct = pred.predict([sess.events()])
    log(f"[{tag}] (g) StreamSession: {sess.n_events} events buffered of "
        f"{len(streams[0])} (horizon {sess.horizon}); rolling == predict "
        f"on the buffer: {np.array_equal(rolling['probs'], direct['probs'][0])}")
    if not np.array_equal(rolling["probs"], direct["probs"][0]):
        raise AssertionError("StreamSession differs from predict([buffer])")
    del em
    torch.cuda.empty_cache()

    # (f) weight=: phase 9's trained FS checkpoint as .npz and .pth
    fs = load_params(files["fs"])
    classes = resolve_class_names(fs, data_root=files["tree"])
    paths = sorted(glob.glob(os.path.join(files["tree"], "testing", "**",
                                          "*.npy"), recursive=True))
    folders = sorted(os.listdir(os.path.join(files["tree"], "testing")))
    truth = np.array([folders.index(os.path.basename(os.path.dirname(p)))
                      for p in paths])
    events = [load_event_file(p) for p in paths]
    bs = int(fs.get("val_batch_size", 64))
    labels = {}
    for fmt in ("npz", "pth"):
        t0 = time.perf_counter()
        fp = Predictor(fs, classes, weight=files[fmt],
                       clip_ckpt=files["pt"], batch_size=bs, device=dev)
        build_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        labels[fmt] = fp.predict(events)["label"]
        wall = time.perf_counter() - t0
        del fp
        torch.cuda.empty_cache()
        correct = int((labels[fmt] == truth).sum())
        log(f"[{tag}] (f) weight={os.path.basename(files[fmt])}: built in "
            f"{build_s:.2f} s, {len(events)} streams in {wall:.2f} s; "
            f"correct {correct} (phase 9(c): "
            f"{int(trained_eval['probs_correct'])})")
        if correct != int(trained_eval["probs_correct"]):
            raise AssertionError(f"weight={fmt}: {correct} correct != phase "
                                 f"9(c)'s {trained_eval['probs_correct']}")
        out[f"weight_{fmt}"] = dict(correct=correct, build_s=build_s,
                                    wall_s=wall)
    if not np.array_equal(labels["npz"], labels["pth"]):
        raise AssertionError(".npz and .pth served different labels")

    # (h) the serve CLI: JSONL from a subprocess, then --embed_out (in
    # this process: a second interpreter only repeats the start-up)
    tmp = os.path.dirname(files["npz"])
    argv = ["--params", files["fs"], "--weight", files["npz"],
            "--clip_ckpt", files["pt"], "--data_root", files["tree"],
            "--batch_size", str(bs), "--inputs",
            os.path.join(files["tree"], "testing", "**", "*.npy")]
    jsonl = os.path.join(tmp, "serve.jsonl")
    emb = os.path.join(tmp, "serve_embed.npz")
    t0 = time.perf_counter()
    subprocess.run([sys.executable, "-m", "eventclip_tpu_torch.serve"]
                   + argv + ["--out", jsonl], cwd=HERE, check=True,
                   timeout=300, stdout=subprocess.DEVNULL)
    cli_s = [time.perf_counter() - t0]
    t0 = time.perf_counter()
    serve_main(argv + ["--embed_out", emb])
    torch.cuda.empty_cache()
    cli_s.append(time.perf_counter() - t0)
    with open(jsonl) as f:
        recs = [json.loads(ln) for ln in f]
    cli_labels = np.array([r["label"] for r in recs])
    with np.load(emb) as z:
        rows = z["embeddings"]
        emb_paths = list(z["paths"])
    log(f"[{tag}] (h) serve CLI: {len(recs)} JSONL lines in {cli_s[0]:.1f} "
        f"s (labels equal (f)'s: {np.array_equal(cli_labels, labels['npz'])}"
        f"); --embed_out {rows.shape} in {cli_s[1]:.1f} s, norms "
        f"{np.linalg.norm(rows, axis=-1).min():.6f}..")
    if len(recs) != len(paths) or [r["path"] for r in recs] != paths or \
            not np.array_equal(cli_labels, labels["npz"]):
        raise AssertionError("serve CLI JSONL differs from Predictor")
    if rows.shape[0] != len(paths) or emb_paths != paths or not np.allclose(
            np.linalg.norm(rows, axis=-1), 1.0, atol=1e-4):
        raise AssertionError("serve CLI embeddings: rows or norms")
    out["cli"] = dict(lines=len(recs), jsonl_s=cli_s[0], embed_s=cli_s[1])
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[{tag}] phase 10 in {out['phase_s']:.1f} s")
    return out, row, pruned_launches


# -- phase 11: ResNet towers, pseudo-labelling and self-training -------------


# RN50 view features, card against the CPU's f32, norm-relative a view:
# f32 (TF32 off) and bf16, each about 4x the worst view read on an H100
# (5.6e-7 and 6.2e-3, see PERF.md); TF32 convolutions would read ~1e-3
RN50_FEATURE_REL = {"float32": 2.5e-6, "bfloat16": 2.5e-2}


def device_busy(fn):
    """(fn(), wall ms, device busy ms or None) of one call, the busy time
    from CUDA-only profiler tracing (kernel time; host ops untraced, so
    the wall time stays close to an untraced run's)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy = 0.0
    for evt in prof.key_averages():
        if getattr(evt, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(evt, "self_device_time_total", None)
        busy += (us if us is not None else evt.self_cuda_time_total) / 1e3
    return out, wall_ms, (busy or None)


def write_tiny_tree(root, seed):
    """A 3-class N-Caltech-shaped tree for the debug configs: 6 training
    and 4 testing streams a class, 2.5k-3.5k events each."""
    rng = np.random.default_rng(seed)
    for label, c in enumerate(("airplanes", "ant", "brain")):
        for split, k in (("training", 6), ("testing", 4)):
            for i in range(k):
                path = os.path.join(root, split, c, f"{c}_{i}.npy")
                os.makedirs(os.path.dirname(path), exist_ok=True)
                np.save(path, synth_events(rng, 2500 + int(rng.integers(
                    0, 1000)), label, 180, 240, 0.3))
    return root


def tree_map(root):
    """{relative path: real path of a link, or 'dir'} under root."""
    out = {}
    for dp, dirs, fs in os.walk(root):
        for name in dirs + fs:
            p = os.path.join(dp, name)
            out[os.path.relpath(p, root)] = (os.path.realpath(p)
                                             if os.path.islink(p) else "dir")
    return out


def run_gen_data(argv):
    """cli.gen_data.main in this process: (result, stdout, the selection
    report from 'Class stats:' to the tree line)."""
    import contextlib
    import io

    from eventclip_tpu_torch.cli import gen_data

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = gen_data.main(argv)
    out = buf.getvalue()
    end = out.find("Pseudo-label dataset tree")
    return res, out, out[out.index("Class stats:"):end if end >= 0 else None]


def check_pseudo_tree(save, src, classes, topk=0, gt=None):
    """A pseudo tree's invariants: a folder for every class (CoOp renames
    inverted, first match), links only to real files of the source tree,
    at most `topk` links a class, every GT file of `gt` ({rel: class
    name}) linked under its class's folder. Returns links a folder."""
    from eventclip_tpu_torch.data.datasets import CALTECH_NEW_CNAMES

    inv = {}
    for k, v in CALTECH_NEW_CNAMES.items():
        inv.setdefault(v, k)
    train = os.path.join(save, "training")
    folders = set(os.listdir(train))
    want = {inv.get(c, c) for c in classes}
    if folders != want:
        raise AssertionError(f"{save}: class folders {sorted(folders ^ want)}"
                             " differ")
    real_src = os.path.realpath(src)
    per = {}
    for f in folders:
        for name in os.listdir(os.path.join(train, f)):
            p = os.path.join(train, f, name)
            real = os.path.realpath(p)
            if not (os.path.islink(p) and os.path.isfile(real)
                    and real.startswith(real_src + os.sep)):
                raise AssertionError(f"{p} -> {real}: not a link to a file "
                                     f"of {src}")
        per[f] = len(os.listdir(os.path.join(train, f)))
    if topk > 0 and max(per.values()) > topk:
        raise AssertionError(f"{save}: {max(per.values())} links in a class "
                             f"> top-{topk}")
    for rel, name in (gt or {}).items():
        fn = rel.split("/")[-1]
        if not os.path.islink(os.path.join(train, inv.get(name, name), fn)):
            raise AssertionError(f"GT {rel} not merged under "
                                 f"{inv.get(name, name)}/")
    return per


def resnet_phase(dev, streams, files, tmp, tag="11 pseudo"):
    """Phase 11(a): a random RN50 CLIP written as OpenAI's fp16 `.pt` (BN
    statistics drawn), served through Predictor (phase 3's 32 x 225k
    request), evaluated through cli.test --arch RN50, its view features
    held card against CPU. Returns the record and the RN50 path's K1 / K2
    launches."""
    import torch

    from eventclip_tpu_torch import kernels
    from eventclip_tpu_torch.cli import test as cli_test
    from eventclip_tpu_torch.engine.trainer import copy_clip
    from eventclip_tpu_torch.models.clip.config import clip_arch_config
    from eventclip_tpu_torch.models.clip.model import init_clip_params
    from eventclip_tpu_torch.models.clip.resnet import (Bottleneck,
                                                        encode_image_resnet)
    from eventclip_tpu_torch.ops.rasterize import rasterize_for_clip
    from eventclip_tpu_torch.serve import Predictor
    from eventclip_tpu_torch.utils.config import load_params

    out = {}
    cfg = clip_arch_config("RN50")
    t0 = time.perf_counter()
    clip = init_clip_params(cfg, torch.Generator(device=dev).manual_seed(11),
                            device=dev)
    with torch.no_grad():  # CLIP zero-inits bn3; a quarter keeps it live
        for m in clip.visual.modules():
            if isinstance(m, Bottleneck):
                m.bn3.weight.fill_(0.25)
    pt = os.path.join(tmp, "RN50.pt")
    torch.save(openai_state_dict(clip, torch.float16, bn_seed=11), pt)
    del clip
    log(f"[{tag}] (a) RN50 random towers saved in fp16 in OpenAI's layout "
        f"({os.path.getsize(pt) / 2 ** 20:.0f} MiB, BN statistics drawn) in "
        f"{time.perf_counter() - t0:.1f} s")
    zs = os.path.join(HERE, "configs", "zsclip", "zsclip_ncaltech_params.py")
    params = load_params(zs)
    params.clip_dict["arch"] = "RN50"
    names = files["classes"]
    kernels.reset_launches()
    t0 = time.perf_counter()
    pred = Predictor(params, names, clip_ckpt=pt, batch_size=32, device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    text_launches = dict(kernels.LAUNCHES)
    pred.warm_up()
    kernels.reset_launches()
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        res = pred.predict(streams)
        times.append(time.perf_counter() - t0)
        check_probs(res, len(streams), len(names))
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    ms = statistics.median(times) * 1e3
    prof = profile_call(f"{tag} profile", "RN50 request 32 x 225k",
                        lambda: pred.predict(streams))
    if prof is not None:
        prof.pop("rows")
    log(f"[{tag}] (a) RN50 Predictor built from the .pt in {build_s:.2f} s "
        f"(text tower launches {text_launches}); request 32 x 225k "
        f"{ms:.1f} ms median of 3 ({len(streams) / (ms / 1e3):.2f} "
        f"streams/s); launches over the 3 requests {launches}")
    if text_launches != {"qkv_attention": cfg.text.layers} or launches != {
            "histogram": 3}:
        raise AssertionError(f"RN50 launches: text {text_launches} (want K2 "
                             f"{cfg.text.layers}), requests {launches} (want "
                             "K1 1 a request, no K2)")
    out["serve"] = dict(ms=ms, build_s=build_s, text_launches=text_launches,
                        launches=launches, profile=prof)

    # view features of one batch of 8 views, card (bf16, then f32 with
    # TF32 switched on around it) against the CPU's f32
    wins, valids = pred.gather_windows(streams[:1])
    with torch.inference_mode():
        imgs = rasterize_for_clip(pred._spec, pred._pp, torch.from_numpy(
            wins).to(dev))[0][torch.from_numpy(valids[0])][:8]
        visual = pred._params.clip.visual
        cpu = copy_clip(pred._params.clip, cfg, "cpu").visual
        want = encode_image_resnet(cpu, imgs.cpu()).double()
        tf32 = (torch.backends.cudnn.allow_tf32,
                torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            got = {"float32": encode_image_resnet(visual, imgs),
                   "bfloat16": encode_image_resnet(visual, imgs,
                                                   dtype=torch.bfloat16)}
        finally:
            (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32) = tf32
    rel = {}
    for k, g in got.items():
        d = g.double().cpu()
        per = (d - want).norm(dim=1) / want.norm(dim=1)
        cos = (d * want).sum(1) / (d.norm(dim=1) * want.norm(dim=1))
        rel[k] = dict(worst_view=float(per.max()), min_cos=float(cos.min()),
                      limit=RN50_FEATURE_REL[k])
    log(f"[{tag}] (a) RN50 view features of 8 views {tuple(imgs.shape)}, "
        f"card vs CPU f32, norm-relative worst view / min cosine: {rel}")
    for k, r in rel.items():
        if not r["worst_view"] <= r["limit"]:
            raise AssertionError(f"RN50 {k} features card vs CPU {r}")
    out["features_card_vs_cpu"] = rel
    del pred, visual, cpu, imgs
    torch.cuda.empty_cache()

    # the arch sweep's first ResNet through the eval CLI, on phase 9's tree
    kernels.reset_launches()
    res = cli_test.main(["--params", zs, "--arch", "RN50", "--clip_ckpt", pt,
                         "--data_root", files["tree"]])
    torch.cuda.synchronize()
    ev = res["ctx"]["evals"][-1]
    cli_launches = dict(kernels.LAUNCHES)
    want = {"histogram": ev["batches"], "qkv_attention": cfg.text.layers}
    log(f"[{tag}] (a) cli.test --arch RN50: {int(ev['n'])} samples in "
        f"{ev['wall_s']:.2f} s ({ev['n'] / ev['wall_s']:.1f} samples/s, "
        f"host loader wait {ev['wait_s']:.2f} s); launches {cli_launches} "
        f"(K2 {cfg.text.layers} for the text tower, K1 1 per eval batch); "
        f"accuracy probs {res['probs_acc']:.4f} (random towers)")
    if cli_launches != want:
        raise AssertionError(f"cli.test RN50 launches {cli_launches} != "
                             f"{want}")
    out["eval_cli"] = dict(n=ev["n"], wall_s=ev["wall_s"],
                           samples_per_s=ev["n"] / ev["wall_s"],
                           host_wait_s=ev["wait_s"], launches=cli_launches)
    del res
    torch.cuda.empty_cache()
    return out, {"histogram": launches["histogram"],
                 "qkv_attention": text_launches["qkv_attention"]}


def teacher_run(tag, label, argv, L, Lt, calib=0):
    """One cli.gen_data run on the card, counted and traced: samples/s,
    views/s, loader wait, device busy, K1 / K2 a batch (text tower and
    calibration batches apart)."""
    import torch

    from eventclip_tpu_torch import kernels

    kernels.reset_launches()
    (res, stdout, report), wall_ms, busy = device_busy(
        lambda: run_gen_data(argv))
    launches = dict(kernels.LAUNCHES)
    st = res["stats"]
    b = st["batches"]
    want = {"histogram": b + calib, "qkv_attention": Lt + L * (b + calib)}
    total = [ln for ln in report.splitlines() if "\tSelect " in ln]
    rec = dict(samples=st["samples"], views=st["views"], batches=b,
               loop_s=st["wall_s"], wait_s=st["wait_s"],
               samples_per_s=st["samples"] / st["wall_s"],
               views_per_s=st["views"] / st["wall_s"], cli_wall_ms=wall_ms,
               busy_ms=busy, launches=launches, totals=total,
               accuracy=res["accuracy"])
    log(f"[{tag}] (b) teacher {label}: {st['samples']} samples, "
        f"{st['views']} real views in {b} batches, {st['wall_s']:.2f} s "
        f"({rec['samples_per_s']:.1f} samples/s, {rec['views_per_s']:.0f} "
        f"views/s; loader wait {st['wait_s']:.2f} s); CLI {wall_ms / 1e3:.2f}"
        f" s, device busy " + ("not measured" if busy is None else
                               f"{busy / 1e3:.2f} s ({100 * busy / wall_ms:.1f}"
                               "%)") + f"; launches {launches} (text K2 {Lt},"
        f" then K1 1 / K2 {L} a batch{', calibration 1 batch' if calib else ''}"
        f"); selection {total}")
    if launches != want:
        raise AssertionError(f"teacher {label} launches {launches} != {want}")
    torch.cuda.empty_cache()
    return res, rec, stdout


def pseudo_label_phase(dev, files, tmp, tag="11 pseudo"):
    """Phase 11(b)-(c): phase 9's tree gains 2 unlabeled streams a class;
    three ViT-L/14 teachers label its training split (ZS with TTA
    filters and top-2; the FS teacher from phase 9's checkpoint with the
    2-shot GT merge; int8 calibrated + 128 tokens); the FS student trains
    one epoch on the FS teacher's tree and is evaluated."""
    import shutil

    import torch

    from eventclip_tpu_torch import kernels
    from eventclip_tpu_torch.cli import test as cli_test
    from eventclip_tpu_torch.cli import train as cli_train
    from eventclip_tpu_torch.data.datasets import (CALTECH_NEW_CNAMES,
                                                   load_split_asset)
    from eventclip_tpu_torch.models.clip.config import clip_arch_config
    from eventclip_tpu_torch.utils.config import load_params

    out = {}
    tree, pt, fs, classes = (files["tree"], files["pt"], files["fs"],
                             files["classes"])
    zs = os.path.join(HERE, "configs", "zsclip", "zsclip_ncaltech_params.py")
    cfg = clip_arch_config(load_params(zs).clip_dict["arch"])
    L, Lt = cfg.vision.layers, cfg.text.layers
    t0 = time.perf_counter()
    for label, c in enumerate(classes):
        for i in range(2):
            rng = np.random.default_rng((11, label, i))
            np.save(os.path.join(tree, "training", c,
                                 f"{c}_unlabeled_{i}.npy"),
                    synth_events(rng, int(rng.integers(100000, 225001)),
                                 label, 180, 240, 0.3))
    log(f"[{tag}] (b) {2 * len(classes)} unlabeled streams written in "
        f"{time.perf_counter() - t0:.1f} s; the training split now holds "
        f"{sum(len(f) for _, _, f in os.walk(os.path.join(tree, 'training')))}"
        " streams")
    base = ["--clip_ckpt", pt, "--data_root", tree]

    # 1. ZS, 4-way TTA, consistency and min-prob filters, top-2 a class
    save1 = os.path.join(tmp, "pseudo-zs")
    res, rec, _ = teacher_run(tag, "ZS + TTA", [
        "--params", zs, *base, "--save_path", save1, "--tta",
        "--tta_consistent", "--tta_min_prob", "--topk", "2"], L, Lt)
    rec["links_a_class"] = check_pseudo_tree(save1, tree, list(res["sel"]),
                                             2)
    out["zs_tta"] = rec

    # 2. the FS teacher: phase 9's checkpoint, its 2-shot GT merged
    weight = os.path.join(tmp, "fs-2shot", "best.npz")
    os.makedirs(os.path.dirname(weight))
    shutil.copy(files["npz"], weight)
    save2 = os.path.join(tmp, "pseudo-2shot-fs")
    res, rec, stdout = teacher_run(tag, "FS --weight --gt_shots 2", [
        "--params", fs, *base, "--save_path", save2, "--weight", weight,
        "--gt_shots", "2"], L, Lt)
    # the dataset's class names: its folders, CoOp-renamed, in order
    names = [CALTECH_NEW_CNAMES.get(c, c) for c in
             sorted(os.listdir(os.path.join(tree, "training")))]
    gt = {rel: names[v]
          for rel, v in load_split_asset("NCaltech101", 2, True).items()}
    rec["links_a_class"] = check_pseudo_tree(save2, tree, names, gt=gt)
    if "not found" in stdout:
        raise AssertionError("a GT split file did not resolve")
    out["fs_gt"] = rec
    # phase 13(d) labels the same split again over two ranks
    out["fs_teacher_run"] = dict(argv=[
        "--params", fs, *base, "--weight", weight, "--gt_shots", "2"],
        save=save2, stdout=stdout)

    # 3. int8 with static scales from 1 batch, 128 of 256 patches kept
    res, rec, _ = teacher_run(tag, "ZS --int8 --int8_calib 1 "
                              "--prune_tokens 128", [
        "--params", zs, *base, "--int8", "--int8_calib", "1",
        "--prune_tokens", "128"], L, Lt, calib=1)
    out["int8_pruned"] = rec

    # (c) the FS student: one epoch on the FS teacher's tree (GT + pseudo
    # labels), then the test CLI on its checkpoint. Not on the ZS
    # teacher's: random towers send every stream to one class, so its
    # top-2 keeps two files, less than one batch of 32
    ckpt = os.path.join(tmp, "student")
    kernels.reset_launches()
    t0 = time.perf_counter()
    trainer = cli_train.main(["--params", fs, "--max_epochs", "1",
                              "--clip_ckpt", pt, "--data_root", save2,
                              "--ckpt_base", ckpt])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    steps = len(trainer.step_times)
    evals = min(2, len(trainer.val_loader)) + len(trainer.val_loader)
    vp, vi = trainer.viz_forwards  # the validation GIFs' forwards
    want = {"histogram": steps + evals + vp + vi,
            "qkv_attention": Lt + L * (steps + evals + vp)}
    step_ms = [s * 1e3 for _, s in trainer.step_times]
    med = statistics.median(step_ms)
    log(f"[{tag}] (c) student on the FS teacher's tree: "
        f"{len(trainer.train_set)} samples, {steps} steps, median "
        f"{med:.1f} ms a step ({trainer.global_batch / (med / 1e3):.1f} "
        f"samples/s); CLI wall {wall:.1f} s; launches {launches} (text K2 "
        f"{Lt}, then K1 1 / K2 {L} / K3 0 a step and eval batch)")
    if launches != want or steps < 1:
        raise AssertionError(f"student launches {launches} != {want} "
                             f"({steps} steps)")
    best = os.path.join(ckpt, "joint_fsclip_ncaltech_params", "models",
                        "best.npz")
    n_train = len(trainer.train_set)
    del trainer
    torch.cuda.empty_cache()
    ev = cli_test.main(["--params", fs, "--weight", best, "--clip_ckpt", pt,
                        "--data_root", save2])
    e = ev["ctx"]["evals"][-1]
    log(f"[{tag}] (c) student's best.npz through cli.test on the testing "
        f"split: {int(e['n'])} samples, accuracy probs "
        f"{ev['probs_acc']:.4f} (random towers)")
    out["student"] = dict(samples=n_train, steps=steps, step_ms=step_ms, median_step_ms=med,
                          wall_s=wall, launches=launches,
                          launches_per_step={"histogram": 1,
                                             "qkv_attention": L,
                                             "qkv_attention_bwd": 0},
                          test_n=e["n"], test_probs_acc=ev["probs_acc"])
    del ev
    torch.cuda.empty_cache()
    return out


def gen_data_card_vs_cpu(tmp, tag="11 pseudo"):
    """Phase 11(d): cli.gen_data on the debug ZS config (ViT-T/8@32), then
    with an RN-T@32 override, f32, on a small tree, once on the card and
    once with --cpu, from one `.pt` each (random towers drawn on the CPU)
    and the seeded random text features (EVENTCLIP_ALLOW_RANDOM_TEXT; the
    RN-T@32 text tower has 128 ids): the reports and the trees equal."""
    import torch

    from eventclip_tpu_torch.models.clip.config import clip_arch_config
    from eventclip_tpu_torch.models.clip.model import init_clip_params

    tree = write_tiny_tree(os.path.join(tmp, "tiny"), seed=11)
    src = os.path.join(HERE, "configs", "debug", "zsclip_tiny_params.py")
    with open(src) as f:
        text = f.read()
    rn_cfg = os.path.join(tmp, "zsclip_rn_tiny_params.py")
    with open(rn_cfg, "w") as f:
        f.write(text.replace("arch='ViT-T/8@32'", "arch='RN-T@32'"))
    saved = {k: os.environ.pop(k, None) for k in ("EVENTCLIP_BPE_PATH",)}
    os.environ["EVENTCLIP_ALLOW_RANDOM_TEXT"] = "1"
    out = {}
    try:
        for arch, config in (("ViT-T/8@32", src), ("RN-T@32", rn_cfg)):
            clip = init_clip_params(clip_arch_config(arch),
                                    torch.Generator().manual_seed(12))
            pt = os.path.join(tmp, arch.replace("/", "_") + ".pt")
            torch.save(openai_state_dict(clip), pt)
            got = {}
            for where in ("card", "cpu"):
                save = os.path.join(tmp, f"pseudo-{arch[:2]}-{where}")
                argv = ["--params", config, "--clip_ckpt", pt, "--data_root",
                        tree, "--fp32", "--save_path", save, "--tta",
                        "--tta_consistent", "--tta_min_prob",
                        "--conf_thresh", "0.5"]
                t0 = time.perf_counter()
                res, _, report = run_gen_data(
                    argv + (["--cpu"] if where == "cpu" else []))
                got[where] = (report, tree_map(save),
                              time.perf_counter() - t0)
            equal = got["card"][:2] == got["cpu"][:2]
            sel = [ln.strip() for ln in got["card"][0].splitlines()
                   if "\tSelect " in ln]
            log(f"[{tag}] (d) gen_data {arch} f32 card vs CPU: reports and "
                f"trees equal: {equal} ({len(got['card'][1])} entries; "
                f"{sel}; {got['card'][2]:.1f} / {got['cpu'][2]:.1f} s)")
            if not equal:
                raise AssertionError(f"gen_data {arch}: card and CPU differ")
            out[arch] = dict(equal=equal, entries=len(got["card"][1]),
                             selection=sel)
    finally:
        os.environ.pop("EVENTCLIP_ALLOW_RANDOM_TEXT")
        for k, v in saved.items():
            if v is not None:
                os.environ[k] = v
    return out


def pseudo_labels(dev, streams, files, tmp):
    """Phase 11: (a) RN50, (b) the three teachers, (c) the student, (d)
    gen_data card vs CPU. Returns the record and the RN50 path's
    launches."""
    tag = "11 pseudo"
    t_phase = time.perf_counter()
    rn50, rn50_launches = resnet_phase(dev, streams, files, tmp)
    out = {"rn50": rn50}
    out.update(pseudo_label_phase(dev, files, tmp))
    out["card_vs_cpu"] = gen_data_card_vs_cpu(tmp)
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[{tag}] phase 11 in {out['phase_s']:.1f} s")
    return out, rn50_launches


# -- phase 12: the HTTP server, its client and frozen export bundles --------


def serve_in_thread(server):
    """Run an HTTP server's accept loop on a daemon thread; returns its
    base URL."""
    import threading

    threading.Thread(target=server.serve_forever, daemon=True).start()
    return f"http://127.0.0.1:{server.server_address[1]}"


# one single-stream request per stream of an [n, events, 4] .npy, all at
# once, through the port's client in a process of its own (so the clients
# do not share the server's interpreter lock); prints the wall seconds and
# each answer's name
BURST = """
import json, sys, threading, time
import numpy as np
from eventclip_tpu_torch.client import ServingClient
url, path = sys.argv[1], sys.argv[2]
streams = np.load(path)
names = [None] * len(streams)
def fire(i):
    c = ServingClient(url, timeout=600)
    names[i] = c.predict([streams[i]], top_k=5)["names"][0]
threads = [threading.Thread(target=fire, args=(i,))
           for i in range(len(streams))]
t0 = time.perf_counter()
for t in threads:
    t.start()
for t in threads:
    t.join()
print(json.dumps({"wall_s": time.perf_counter() - t0, "names": names}))
"""


def burst(url, path):
    """BURST against `url` on the streams saved at `path`: (wall seconds,
    the names in stream order)."""
    res = subprocess.run([sys.executable, "-c", BURST, url, path], cwd=HERE,
                         capture_output=True, text=True, timeout=600,
                         check=True)
    out = json.loads(res.stdout.strip().splitlines()[-1])
    if None in out["names"]:
        raise AssertionError("a burst request got no response")
    return out["wall_s"], out["names"]


def server_phase(pred, streams, tmp, tag="12 server"):
    """Phase 12(a): phase 3's predictor behind the port's HTTP server: one
    32 x 225k x-npz request beside the direct call, 32 concurrent
    single-stream requests (from another process) with micro-batching on
    and off, a streaming session, /statz."""
    import torch

    from eventclip_tpu_torch import kernels
    from eventclip_tpu_torch.client import ServingClient
    from eventclip_tpu_torch.server import make_server

    out = {}
    plain = make_server(pred, "127.0.0.1", 0)
    # the idle gap outlasts the gaps between a burst's arrivals, which
    # register only once their 3.6 MB bodies are read and decoded
    fused = make_server(pred, "127.0.0.1", 0, microbatch_ms=300.0,
                        microbatch_idle_ms=100.0)
    try:
        url = serve_in_thread(plain)
        client = ServingClient(url, timeout=600)
        direct_ms, _, _ = timed_requests(pred, streams)
        direct = pred.predict(streams, top_k=5)
        times = []
        for _ in range(3):
            kernels.reset_launches()
            t0 = time.perf_counter()
            got = client.predict(streams, top_k=5, return_probs=True)
            times.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
        http_launches = dict(kernels.LAUNCHES)
        http_ms = statistics.median(times) * 1e3
        same = (np.array_equal(got["label"], direct["label"])
                and got["names"] == direct["names"]
                and np.array_equal(got["topk"], direct["topk"])
                and np.array_equal(got["probs"], direct["probs"]))
        mb = sum(s.nbytes for s in streams) / 1e6
        log(f"[{tag}] (a) {len(streams)} x {len(streams[0])} events as "
            f"x-npz ({mb:.1f} MB): {http_ms:.1f} ms median of 3 over HTTP "
            f"vs {direct_ms:.1f} ms direct Predictor.predict; launches "
            f"{http_launches}; labels, names, top-5 and probs equal the "
            f"direct call's: {same}")
        if not same:
            raise AssertionError("the HTTP answer differs from the direct "
                                 "Predictor.predict")
        one = {"histogram": 1,
               "qkv_attention": pred._cfg.clip.vision.layers}
        if http_launches != one:
            raise AssertionError(f"HTTP request launches {http_launches}")
        out["request"] = dict(http_ms=http_ms, direct_ms=direct_ms,
                              body_mb=mb, launches=http_launches)

        # 32 concurrent single-stream requests, fused then serialized
        furl = serve_in_thread(fused)
        path = os.path.join(tmp, "burst.npy")
        np.save(path, np.stack(streams))
        for label, u in (("microbatch on", furl), ("microbatch off", url)):
            n_log = len(fused.batcher.batch_log)
            kernels.reset_launches()
            wall, res = burst(u, path)
            torch.cuda.synchronize()
            launches = dict(kernels.LAUNCHES)
            # a single-stream forward may round differently from the
            # 32-stream one (another batch shape): agreement is printed
            agree = sum(r == direct["names"][i] for i, r in enumerate(res))
            rec = dict(wall_s=wall, streams_per_s=len(streams) / wall,
                       launches=launches, labels_as_direct=agree)
            if u == furl:
                batches = list(fused.batcher.batch_log)[n_log:]
                rec["batches"] = batches
                per = {k: v / len(batches) for k, v in launches.items()}
                phases = {k: round(statistics.mean(b[k] for b in batches), 1)
                          for k in ("window_ms", "close_ms", "lock_ms",
                                    "device_ms", "slice_ms")}
                log(f"[{tag}] (a) {len(streams)} concurrent single-stream "
                    f"requests, {label}: {wall:.2f} s, "
                    f"{rec['streams_per_s']:.2f} streams/s; "
                    f"labels as the 32-stream call's {agree}/{len(res)}; "
                    f"{len(batches)} fused batches of "
                    f"{[b['streams'] for b in batches]} streams, mean "
                    f"phases {phases} ms; launches per fused batch {per}")
            else:
                log(f"[{tag}] (a) {len(streams)} concurrent single-stream "
                    f"requests, {label}: {wall:.2f} s, "
                    f"{rec['streams_per_s']:.2f} streams/s; labels as the "
                    f"32-stream call's {agree}/{len(res)}; launches "
                    f"{launches} ({launches.get('histogram', 0)} forwards)")
            out[label.replace(" ", "_")] = rec

        # one streaming session: 4 appends, each with a rolling prediction
        chunk_ms = []
        with client.open_session() as sess:
            for chunk in np.array_split(streams[0], 4):
                t0 = time.perf_counter()
                r = sess.append(chunk, predict=True, top_k=5)
                chunk_ms.append((time.perf_counter() - t0) * 1e3)
            want = pred.predict([streams[0][-sess.horizon:]], top_k=5)
        if not (r["name"] == want["names"][0] and np.array_equal(
                np.asarray(r["probs"], np.float32), want["probs"][0])):
            raise AssertionError("session prediction differs from predict "
                                 "on its buffer")
        log(f"[{tag}] (a) session: 4 appends of {len(streams[0]) // 4} "
            f"events with predict, {[round(m, 1) for m in chunk_ms]} ms; "
            f"{r['n_events']} events buffered (horizon {r['horizon']}); "
            "the last prediction equals predict on the buffer")
        out["session_ms"] = chunk_ms
        out["statz"] = client.stats()
        log(f"[{tag}] (a) /statz {json.dumps(out['statz'])}")
    finally:
        fused.shutdown()
        plain.shutdown()
        fused.server_close()
        plain.server_close()
    os.remove(os.path.join(tmp, "burst.npy"))
    return out


def dispatch_cost(dev, tag="12 dispatch"):
    """K1 and K2 at the serving shape through their custom ops (the path
    every caller takes) beside their launchers called directly, and the
    host cost of one call of each at a tiny shape."""
    import torch

    from eventclip_tpu_torch.ops import attention as A
    from eventclip_tpu_torch.ops import rasterize as R

    gen = torch.Generator(device=dev).manual_seed(12)
    qkv = torch.randn((320, 257, 3072), generator=gen,
                      device=dev).to(torch.bfloat16)
    wins = synth_windows(gen, 320, 20000, 180, 240, dev)
    plan = R.device_histogram_plan(dev, 180, 240)
    if not (torch.equal(A.fused_qkv_attention(qkv, 16),
                        A.launch_qkv_attention(qkv, 16, None))
            and torch.equal(R.histograms(wins, 180, 240),
                            R.launch_histograms(wins, 180, 240, plan))):
        raise AssertionError("a custom op differs from its launcher")
    out = {"qkv_attention": (cuda_ms(lambda: A.fused_qkv_attention(qkv, 16)),
                             cuda_ms(lambda: A.launch_qkv_attention(
                                 qkv, 16, None))),
           "histogram": (cuda_ms(lambda: R.histograms(wins, 180, 240)),
                         cuda_ms(lambda: R.launch_histograms(
                             wins, 180, 240, plan)))}
    small = torch.randn((2, 17, 192), device=dev)
    host = {}
    for name, fn in (("op", lambda: A.fused_qkv_attention(small, 2)),
                     ("launcher",
                      lambda: A.launch_qkv_attention(small, 2, None))):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(1000):
            fn()
        host[name] = (time.perf_counter() - t0) * 1e3  # us a call
        torch.cuda.synchronize()
    log(f"[{tag}] K2 [320, 257, 3072] bf16 through the op "
        f"{out['qkv_attention'][0]:.4f} ms, its launcher "
        f"{out['qkv_attention'][1]:.4f} ms; K1 [320, 20000, 3] "
        f"{out['histogram'][0]:.4f} / {out['histogram'][1]:.4f} ms; bit "
        f"equal; host time a call {host['op']:.1f} us through the op, "
        f"{host['launcher']:.1f} us to the launcher")
    del qkv, wins
    return dict(ms=out, host_us=host)


def graph_targets(module):
    """(op names, device types of the tensors held) of a loaded program
    (an `ExportedProgram.module()`)."""
    targets = {str(n.target) for n in module.graph.nodes}
    held = {t.device.type for t in [*module.parameters(), *module.buffers()]}
    for n in module.graph.nodes:
        if n.op == "get_attr":
            t = module
            for part in str(n.target).split("."):
                t = getattr(t, part)
            if hasattr(t, "device"):
                held.add(t.device.type)
    return targets, held


def export_phase(dev, pred, streams, tmp, tag="12 export"):
    """Phase 12(b): phase 3's predictor frozen into a bundle of two graph
    sets, the card's and the CPU's (embeddings on, phase 9's merge table
    shipped for offline label swaps): export and load seconds, weights vs
    programs, request ms, launches and prob delta vs the live predictor,
    the embeddings vs the live ones, K1 and K2 device ms a launch inside
    the bundle's requests (torch.profiler, after a warm-up, each kernel's
    traced launches counted against kernels.LAUNCHES), and the offline
    set_classes vs the live swap; then the CPU's set: its load, one short
    packed request and the offline swap against a live CPU predictor on
    the same leaves, no launch, and its graphs free of card ops and
    constants."""
    import torch

    from eventclip_tpu_torch import kernels
    from eventclip_tpu_torch.export import ExportedPredictor, export_predictor

    live_ms, _, live = timed_requests(pred, streams)
    # the bundle carries the embed program; phase 3 built its predictor
    # without it, and the flag only gates the (same) padded step's use
    pred._embed = True
    path = os.path.join(tmp, "model.eclip")
    t0 = time.perf_counter()
    meta = export_predictor(pred, path, platforms=["cuda", "cpu"])
    export_s = time.perf_counter() - t0
    if {p: s["set"] for p, s in meta["sets"].items()} != {"cuda": "cuda",
                                                         "cpu": "cpu"}:
        raise AssertionError(f"bundle sets {meta['sets']}")
    t0 = time.perf_counter()
    ex = ExportedPredictor(path, device=dev)
    load_s = time.perf_counter() - t0
    file_mb = os.path.getsize(path) / 1e6
    ms, launches, got = timed_requests(ex, streams)
    delta = float(np.abs(got["probs"] - live["probs"]).max())
    by_set = {s: sum(v for k, v in meta["program_bytes"].items()
                     if k.startswith(s + "/")) / 1e6 for s in ("cuda", "cpu")}
    out = dict(export_s=export_s, load_s=load_s, file_mb=file_mb,
               weights_mb=meta["weight_bytes"] / 1e6, programs_mb=by_set,
               programs={k: v / 1e6 for k, v in
                         meta["program_bytes"].items()},
               ms=ms, live_ms=live_ms, prob_delta=delta, launches=launches)
    log(f"[{tag}] (b) bundle: exported in {export_s:.1f} s "
        f"({len(meta['program_bytes'])} programs, two sets): {file_mb:.1f} "
        f"MB on disk, of which weights {out['weights_mb']:.1f} MB (stored "
        f"once) and programs {by_set['cuda']:.2f} MB (card) + "
        f"{by_set['cpu']:.2f} MB (CPU) before deflate; loaded on the card "
        f"in {load_s:.1f} s; request {ms:.1f} ms vs live {live_ms:.1f} ms; "
        f"max prob delta vs live {delta:.2e}; launches {launches}")
    want = {"histogram": 1, "qkv_attention": pred._cfg.clip.vision.layers}
    if launches != want:
        raise AssertionError(f"bundle launches {launches}, want {want}")
    if delta > 1e-4:
        raise AssertionError(f"bundle prob delta {delta} > 1e-4")
    # random towers give near one-hot probabilities; a wrong graph (a
    # dropped block, a wrong mask) moves the features themselves
    few = streams[:8]
    d = float(np.abs(ex.embed(few) - pred.embed(few)).max())
    log(f"[{tag}] (b) embed: bundle vs live, max delta {d:.2e} over "
        f"{len(few)} streams")
    if d > 1e-4:
        raise AssertionError(f"bundle embed delta {d} > 1e-4")
    out["embed_delta"] = d
    # K1 and K2 inside the bundle's requests: device ms a launch, over
    # the launches the trace holds, counted against the launches made in
    # the traced window (after one untraced warm-up request), and for
    # each request its K1 and K2 rows on the device
    ex.predict(streams)

    def requests():
        for i in range(TRACED_REQUESTS):
            with torch.profiler.record_function(f"{REQUEST_RANGE} {i}"):
                ex.predict(streams)

    kernels.reset_launches()
    prof = profile_call(tag, f"{TRACED_REQUESTS} exported requests",
                        requests, keep=True)
    made = dict(kernels.LAUNCHES)
    out["kernel_ms"], out["traced_launches"] = {}, {}
    for name, sym in (("histogram", "hist_kernel"),
                      ("qkv_attention", "attention_tc_kernel")):
        rows = [r for r in (prof or {}).get("rows", []) if sym in r[2]]
        n = sum(r[1] for r in rows)
        out["traced_launches"][name] = dict(traced=n, made=made.get(name, 0),
                                            rows=[r[2][:80] for r in rows])
        out["kernel_ms"][name] = (sum(r[0] for r in rows) / n if n
                                  else None)
    if prof is not None:
        out["k1_by_request"] = k1_by_request(prof.pop("prof"))
        out["profile"] = dict(wall_ms=prof["wall_ms"],
                              busy_ms=prof["busy_ms"])
    log(f"[{tag}] (b) in the bundle's requests, device ms a launch: "
        + ", ".join(f"{k} " + ("not measured" if v is None else f"{v:.4f}")
                    + " ({traced} launches traced of {made} made; rows "
                    "{rows})".format(**out["traced_launches"][k])
                    for k, v in out["kernel_ms"].items()))
    if "k1_by_request" in out:
        log(f"[{tag}] (b) each traced request: (K1 rows, K2 rows, K1 "
            f"device ms): {out['k1_by_request']}")
    # the same kernel timed back to back by CUDA events, through the op,
    # on the request's windows and on phase 2's synthetic windows of the
    # same shape (uniform pixels; the request's events pile on a blob)
    wins, _ = ex.gather_windows(streams)
    flat = torch.from_numpy(wins.reshape((-1,) + wins.shape[-2:])).to(dev)
    h, w = pred.resolution
    synth = synth_windows(torch.Generator(device=dev).manual_seed(0),
                          *flat.shape[:2], h, w, dev)
    out["histogram_events_ms"] = {
        label: cuda_ms(lambda x=x: torch.ops.eventclip.event_histogram(
            x, h, w)) for label, x in (("request", flat), ("synth", synth))}
    log(f"[{tag}] (b) K1 at {tuple(flat.shape)}, CUDA events back to back: "
        f"{out['histogram_events_ms']['request']:.4f} ms on the request's "
        f"windows, {out['histogram_events_ms']['synth']:.4f} ms on phase "
        "2's synthetic ones")
    # the live CPU predictor on the same leaves, copied before any swap
    live_cpu = pred.on_device("cpu")
    # offline label swap vs the live one (reversed names, phase 9's table)
    rev = list(reversed(pred.class_names))
    ex.set_classes(rev)
    pred.set_classes(rev)
    d = float(np.abs(ex.predict(few)["probs"]
                     - pred.predict(few)["probs"]).max())
    log(f"[{tag}] (b) offline set_classes (reversed names) vs the live "
        f"swap: max prob delta {d:.2e}")
    if d > 1e-4:
        raise AssertionError(f"offline set_classes delta {d} > 1e-4")
    out["set_classes_delta"] = d
    del ex
    torch.cuda.empty_cache()
    out["cpu"] = bundle_on_cpu(live_cpu, path, streams[:1], tag)
    os.remove(path)  # 1.7 GB
    pred._embed = False
    return out


def k1_by_request(prof):
    """For each "bundle request i" range of a profile: (K1 rows, K2 rows
    on the device inside it, the device ms of its K1 rows). A request's
    kernels run inside its range: each request ends by copying its
    probabilities to the host."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    events = prof.events()
    ranges = sorted((e.time_range.start, e.time_range.end)
                    for e in events if e.name.startswith(REQUEST_RANGE)
                    and e.device_type != cuda)
    kernel = [(e.time_range.start, e.name, e.time_range.elapsed_us())
              for e in events if e.device_type == cuda]
    out = []
    for start, end in ranges:
        inside = [(name, us) for t, name, us in kernel if start <= t <= end]
        k1 = [round(us / 1e3, 4) for name, us in inside
              if "hist_kernel" in name]
        k2 = sum(1 for name, _ in inside if "attention_tc_kernel" in name)
        out.append((len(k1), k2, k1))
    return out


def bundle_on_cpu(live, path, streams, tag):
    """Phase 12(b), the CPU's graph set of the bundle at `path`: load
    seconds, one short packed request and the offline swap against the
    live CPU predictor `live` on the same leaves, no kernel launched, and
    its graphs free of the card's GEMMs (`aten.mm.dtype`) and of tensors
    on the card."""
    from eventclip_tpu_torch import kernels
    from eventclip_tpu_torch.export import ExportedPredictor

    t0 = time.perf_counter()
    ex = ExportedPredictor(path, device="cpu")
    load_s = time.perf_counter() - t0
    programs = [ex._step, *ex._step_packed.values(), ex._embed_step,
                ex._text_step]
    for prog in programs:
        targets, held = graph_targets(prog)
        if "aten.mm.dtype" in targets or held - {"cpu"}:
            raise AssertionError(f"the CPU set holds card ops or tensors: "
                                 f"mm.dtype {'aten.mm.dtype' in targets}, "
                                 f"devices {held}")
    kernels.reset_launches()
    t0 = time.perf_counter()
    got = ex.predict(streams)
    ms = (time.perf_counter() - t0) * 1e3
    launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
    if launches:
        raise AssertionError(f"the CPU set launched kernels {launches}")
    t0 = time.perf_counter()
    want = live.predict(streams)
    live_ms = (time.perf_counter() - t0) * 1e3
    delta = float(np.abs(got["probs"] - want["probs"]).max())
    if delta > 1e-5 or not np.array_equal(got["label"], want["label"]):
        raise AssertionError(f"CPU set vs live CPU: prob delta {delta}")
    # the offline swap: the text program's features against the live
    # text tower's, both on the CPU (a request after it would add two
    # more 80-view ViT-L/14 forwards on the host)
    rev = list(reversed(live.class_names))
    t0 = time.perf_counter()
    ex.set_classes(rev)
    swap_s = time.perf_counter() - t0
    live.set_classes(rev)
    feats = ex._params[ex._tf_idx]
    swap = float((feats - live._params.text_feats).abs().max())
    if swap > 1e-5:
        raise AssertionError(f"CPU set's offline swap vs live: {swap}")
    out = dict(load_s=load_s, request_ms=ms, live_ms=live_ms,
               views=int(sum(ex.gather_windows(streams)[1].sum(-1))),
               prob_delta=delta, swap_feature_delta=swap, swap_s=swap_s,
               programs=len(programs), launches=launches)
    log(f"[{tag}] (b) the CPU's set: loaded in {load_s:.1f} s; one "
        f"request of {out['views']} views (packed into the smallest bucket, "
        f"{min(ex._buckets)} views) in {ms:.0f} ms vs live CPU {live_ms:.0f}"
        f" ms; max prob delta {delta:.2e}; no launch; offline swap in "
        f"{swap_s:.1f} s, text features vs the live swap {swap:.2e}; "
        f"{len(programs)} graphs hold no aten.mm.dtype and no card tensor")
    return out


def export_cli_check(files, tmp, tag="12 export"):
    """Phase 12(c): the export CLI's own --check in a subprocess on the
    card (phase 9's tree, checkpoint and merge table, ZS on N-Caltech at
    ViT-L/14), padded programs only (EVENTCLIP_NO_PACK_EVAL: (b) froze the
    packed ones)."""
    zs = os.path.join(HERE, "configs", "zsclip", "zsclip_ncaltech_params.py")
    out = os.path.join(tmp, "cli.eclip")
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "eventclip_tpu_torch.export", "--params", zs,
         "--data_root", files["tree"], "--clip_ckpt", files["pt"],
         "--out", out, "--check"],
        cwd=HERE, capture_output=True, text=True, timeout=600,
        env=dict(os.environ, EVENTCLIP_NO_PACK_EVAL="1"))
    wall = time.perf_counter() - t0
    if os.path.exists(out):
        os.remove(out)
    lines = [ln for ln in res.stdout.splitlines()
             if ln.startswith(("wrote", "check"))]
    for ln in lines:
        log(f"[{tag}] (c) {ln}")
    if res.returncode != 0 or "check OK" not in res.stdout:
        raise AssertionError(f"export --check failed ({res.returncode}):\n"
                             f"{res.stdout[-2000:]}\n{res.stderr[-4000:]}")
    log(f"[{tag}] (c) export CLI --check in a subprocess: {wall:.1f} s")
    return dict(wall_s=wall, lines=lines)


def server_and_export(dev, pred, streams, files, tmp):
    """Phase 12: the custom ops' dispatch cost, (a) server, (b) export
    bundles, (c) the export CLI."""
    t_phase = time.perf_counter()
    out = {"dispatch": dispatch_cost(dev)}
    out["server"] = server_phase(pred, streams, tmp)
    out["export"] = export_phase(dev, pred, streams, tmp)
    out["export_cli"] = export_cli_check(files, tmp)
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[12 server/export] phase 12 in {out['phase_s']:.1f} s")
    return out


# -- phase 13: data parallelism, the trainer extras, sharded pseudo-labels ---


# 13(b): two gloo ranks against one process, FS at ViT-L/14 on the card,
# after 3 steps, element by element over the trained f32 leaves (adapter,
# prompts). The key bias is held apart: softmax is shift-invariant in it,
# so its gradient is rounding noise and Adam moves it by about lr whatever
# the noise's sign (at most 2 lr a step apart). Of the other elements all
# but a share DDP_FS_SHARE lie within DDP_FS_ATOL: each rank runs the
# frozen bf16 tower at half the batch, where the GEMMs may sum in another
# order, so an element whose gradient is near zero may flip its Adam step.
# A rank that skipped the all-reduce, or drew other RandAugment or dropout
# rows, moves most elements by about lr (1e-4) away.
DDP_FS_ATOL = 1e-6
DDP_FS_SHARE = 1e-3
# 13(b)'s eval: each real sample's aggregated logits and probs (the ranks'
# rows of a batch in rank order) within DDP_ROWS_RTOL of their largest
# value of one process's, and the CE loss within DDP_CE_RTOL (the sound
# run on the card read a gap of 8e-8). Random towers bring every sample's
# features close together, so the rows must also lie at least ten
# tolerances apart from one sample to the next: else a view mapped to the
# wrong sample would pass.
DDP_ROWS_RTOL = 1e-5
DDP_CE_RTOL = 1e-5
DDP_TIMEOUT_S = 300  # a hung rendezvous fails the phase, not the call


def trained_leaves(trainer):
    """{name: CPU copy} of the parameters the optimizer trains."""
    return {n: p.detach().cpu().clone()
            for n, p in trainer.model_params.named_parameters()
            if p.requires_grad}


def compare_leaves(got, want, lr_steps):
    """Phase 13's leaf comparison (see DDP_FS_ATOL): the max |diff| and
    the share above DDP_FS_ATOL off the key bias, the key bias's max
    |diff|, and whether every leaf is bit-equal."""
    import torch

    off, bias, above, n = 0.0, 0.0, 0, 0
    for name, w in want.items():
        d = (got[name].double() - w.double()).abs().reshape(-1)
        key = torch.zeros(d.numel(), dtype=torch.bool)
        if name.endswith("attn.bqkv"):
            D = d.numel() // 3
            key[D:2 * D] = True
        off = max(off, float(d[~key].max()) if (~key).any() else 0.0)
        bias = max(bias, float(d[key].max()) if key.any() else 0.0)
        above += int((d[~key] > DDP_FS_ATOL).sum())
        n += int((~key).sum())
    equal = all(torch.equal(got[k], want[k]) for k in want)
    return dict(max_diff=off, share_above=above / max(n, 1),
                key_bias_max_diff=bias, key_bias_bound=2 * lr_steps,
                bit_equal=equal)


def ddp_fs_trainer(dev, ckpt_dir, **over):
    """Phase 13's FS trainer: joint_fsclip_ncaltech_params.py at its own
    widths (ViT-L/14 frozen, bf16, the text-trans adapter with its dropout,
    RandAugment), global batch 32, 2 epochs of 3 steps on a synthetic
    N-Caltech set, val 34 streams x 10 views in batches of 16 (the last,
    of 2 streams, leaves a second rank none), eval every epoch, saves only
    at the end (so a preemption forces its own), no GIFs unless `over`
    sets `visualize`. `over` sets further config keys."""
    from eventclip_tpu_torch.data.event_windows import EventWindowDataset
    from eventclip_tpu_torch.engine.trainer import EventCLIPTrainer
    from eventclip_tpu_torch.utils.config import load_params

    params = load_params(os.path.join(HERE, "configs", "fsclip",
                                      "joint_adapter",
                                      "joint_fsclip_ncaltech_params.py"))
    over = dict(dict(max_epochs=2, eval_interval=1, save_interval=5,
                     val_batch_size=16, visualize=False, num_workers=4),
                **over)
    for k, v in over.items():
        setattr(params, k, v)
    q = dict(params.quantize_args)
    bs = int(params.train_batch_size)
    train = EventWindowDataset(SyntheticNCaltech(3 * bs, seed=1), q,
                               augment=bool(params.get("img_aug", False)))
    val = EventWindowDataset(SyntheticNCaltech(34, seed=2),
                             dict(q, max_imgs=10))
    return EventCLIPTrainer(params, train, val, ckpt_dir,
                            log_file=os.path.join(ckpt_dir, "metrics.jsonl"),
                            smoke=True, seed=0, device=dev)


def ddp_fs_rank(rank, port, out_dir, device):
    """One of phase 13(b)'s two gloo ranks on the one card (a spawned
    process): 3 FS steps, the eval, the boundary save; writes its trained
    leaves, launches, eval (and its per-sample rows) and step times
    under out_dir."""
    import torch

    sys.path.insert(0, HERE)
    from eventclip_tpu_torch import kernels
    from eventclip_tpu_torch.parallel import distributed as D
    from tests.torch_ddp_worker import evaluate_rows

    D.initialize_distributed(f"localhost:{port}", 2, rank, backend="gloo",
                             device=device)
    dev = torch.device(device)
    trainer = ddp_fs_trainer(dev, os.path.join(out_dir, f"rank{rank}"))
    kernels.reset_launches()
    trainer.train_epoch(0)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    ev, logits, probs = evaluate_rows(trainer)
    np.savez(os.path.join(out_dir, f"eval_rows{rank}.npz"),
             **{f"logits{i}": x for i, x in enumerate(logits)},
             **{f"probs{i}": x for i, x in enumerate(probs)})
    trainer.save(0, ev)
    torch.save(trained_leaves(trainer),
               os.path.join(out_dir, f"leaves{rank}.pt"))
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(dict(launches=launches, eval=ev,
                       step_ms=[s * 1e3 for _, s in trainer.step_times],
                       wait_ms=[w * 1e3 for w, _ in trainer.step_times],
                       backend=torch.distributed.get_backend(),
                       device=str(trainer.device),
                       local_batch=trainer.train_loader.local_batch,
                       cards=torch.cuda.device_count()), f)
    D.shutdown_distributed()


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def ft_ddp_trainer(dev, ckpt_dir, batch, n_model=1, zero1=False):
    """Phase 13(a)'s FT trainer: ft_text_fsclip_nin_params.py at full width
    (ViT-L/14, bf16, remat, RandAugment), batch cut to `batch` x 2 views,
    3 steps; phase 14 sets `n_model` (tensor parallelism over the process
    group) and `zero1`."""
    from eventclip_tpu_torch.data.event_windows import EventWindowDataset
    from eventclip_tpu_torch.engine.trainer import EventCLIPTrainer
    from eventclip_tpu_torch.utils.config import load_params

    params = load_params(os.path.join(HERE, "configs", "ftclip",
                                      "ft_text_fsclip_nin_params.py"))
    params.train_batch_size, params.val_batch_size = batch, 8
    params.max_epochs, params.visualize = 1, False
    params.zero1 = zero1
    q = dict(params.quantize_args)
    train = EventWindowDataset(SyntheticNImageNet(3 * batch, seed=1), q,
                               augment=bool(params.get("img_aug", False)))
    val = EventWindowDataset(SyntheticNImageNet(8, seed=2),
                             dict(q, max_imgs=10))
    return EventCLIPTrainer(params, train, val, ckpt_dir,
                            log_file=os.path.join(ckpt_dir, "metrics.jsonl"),
                            smoke=True, seed=0, device=dev, n_model=n_model)


def nccl_one_rank(dev, tmp, batch=32, tag="13 ddp"):
    """Phase 13(a) and the profile of (c): 3 bf16 FT steps at ViT-L/14
    with no process group, then the same 3 steps under a one-rank NCCL
    group (counted: the ddp path), leaves compared bit for bit; then 2
    more steps traced by `profile_steps` and the metrics lines read."""
    import torch

    from eventclip_tpu_torch import kernels
    from eventclip_tpu_torch.parallel import distributed as D

    out = {}
    t0 = time.perf_counter()
    plain = ft_ddp_trainer(dev, os.path.join(tmp, "plain"), batch)
    plain.train_epoch(0)
    torch.cuda.synchronize()
    plain_ms = [s * 1e3 for _, s in plain.step_times]
    want = trained_leaves(plain)
    L = plain.clip_cfg.vision.layers
    del plain
    torch.cuda.empty_cache()
    D.initialize_distributed(f"localhost:{free_port()}", 1, 0,
                             backend="nccl", device=dev)
    try:
        trainer = ft_ddp_trainer(dev, os.path.join(tmp, "nccl"), batch)
        # the ddp path's run: counts zeroed just before, read just after
        kernels.reset_launches()
        trainer.train_epoch(0)
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
        nccl_ms = [s * 1e3 for _, s in trainer.step_times]
        cmp = compare_leaves(trained_leaves(trainer), want, 0.0)
        backend = torch.distributed.get_backend()
        log(f"[{tag}] (a) bf16 FT ViT-L/14, batch {batch} x 2 views (cut "
            f"from 128 to keep chip_smoke within its time), one rank over "
            f"{backend}: steps {[round(x, 1) for x in nccl_ms]} ms "
            f"(median {statistics.median(nccl_ms):.1f}) against "
            f"{[round(x, 1) for x in plain_ms]} with no group (median "
            f"{statistics.median(plain_ms):.1f}); {len(want)} trained "
            f"leaves {'bit-equal' if cmp['bit_equal'] else 'NOT bit-equal'}"
            f" (max |diff| {cmp['max_diff']:.3g}); launches {launches} "
            f"(K1 1, K2 {2 * L}, K3 {L} a step expected)")
        if not cmp["bit_equal"]:
            raise AssertionError(f"one-rank NCCL steps differ from the "
                                 f"plain steps: {cmp}")
        steps = len(nccl_ms)
        if launches != {"histogram": steps, "qkv_attention": 2 * L * steps,
                        "qkv_attention_bwd": L * steps}:
            raise AssertionError(f"ddp launches {launches}")
        out.update(batch=batch, plain_step_ms=plain_ms, nccl_step_ms=nccl_ms,
                   launches=launches, bit_equal=True)

        # (c) profile_steps = 2 (what --profile 2 sets): a trace of 2
        # steps after 1 warm-up step, on this trainer
        trainer.profile_steps = 2
        trainer.train_epoch(0)
        tr = trainer.profile_trace
        with open(tr["path"]) as f:
            text = f.read()
        names = {k: n for k, n in (("K1", "hist_kernel"),
                                   ("K2", "attention_tc_kernel"),
                                   ("K3 dq", "dq_tc_kernel"),
                                   ("K3 dkdv", "dkdv_tc_kernel"))}
        missing = [k for k, n in names.items() if n not in text]
        log(f"[{tag}] (c) profile_steps 2: {os.path.relpath(tr['path'], tmp)}"
            f", {tr['bytes'] / 2 ** 20:.1f} MiB written in "
            f"{tr['write_s']:.2f} s; names {sorted(names.values())}: "
            f"{'all present' if not missing else f'missing {missing}'}")
        if missing:
            raise AssertionError(f"the trace lacks {missing}")
        lines = [json.loads(ln) for ln in open(trainer.log_file)]
        if not lines or any(ln.get("run_id") != trainer.run_id
                            for ln in lines):
            raise AssertionError(f"metrics lines without run_id: {lines}")
        log(f"[{tag}] (c) run_id {trainer.run_id!r} on all {len(lines)} "
            "metrics lines")
        out.update(trace_mib=tr["bytes"] / 2 ** 20,
                   trace_write_s=tr["write_s"], run_id_lines=len(lines))
        del trainer
    finally:
        D.shutdown_distributed()
    torch.cuda.empty_cache()
    out["wall_s"] = time.perf_counter() - t0
    return out


def spawn_fs_ranks(dev, tmp):
    """Phase 13(b)'s two ranks on `dev` (torch.multiprocessing, spawn),
    within DDP_TIMEOUT_S; returns their records and leaves."""
    import torch
    import torch.multiprocessing as mp

    out_dir = os.path.join(tmp, "ranks")
    os.makedirs(out_dir)
    ctx = mp.start_processes(ddp_fs_rank,
                             args=(free_port(), out_dir, str(dev)),
                             nprocs=2, join=False, start_method="spawn")
    deadline = time.monotonic() + DDP_TIMEOUT_S
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise AssertionError(f"the 2 ranks did not finish within "
                                 f"{DDP_TIMEOUT_S} s")
    recs = [json.load(open(os.path.join(out_dir, f"rank{r}.json")))
            for r in (0, 1)]
    leaves = [torch.load(os.path.join(out_dir, f"leaves{r}.pt"))
              for r in (0, 1)]
    return out_dir, recs, leaves


def compare_eval_rows(out_dir, rows0):
    """13(b): the two ranks' per-sample eval rows (eval_rows<r>.npz), a
    batch's rows concatenated in rank order, against one process's
    (`evaluate_rows`'s logits and probs lists). Raises past DDP_ROWS_RTOL,
    or when two samples' logits lie closer than ten tolerances."""
    got = []
    for r in (0, 1):
        with np.load(os.path.join(out_dir, f"eval_rows{r}.npz")) as z:
            got.append(dict(z))
    res = {}
    for name, want in zip(("logits", "probs"), rows0):
        g = np.concatenate([x[f"{name}{i}"] for i in range(len(want))
                            for x in got])
        w = np.concatenate(want)
        if g.shape != w.shape:
            raise AssertionError(f"eval {name} rows {g.shape} != {w.shape}")
        res[f"{name}_err"] = float(np.abs(g - w).max() / np.abs(w).max())
    w = np.concatenate(rows0[0])
    res["samples"] = len(w)
    res["separation"] = float(min(
        np.abs(w[i] - w[j]).max() for i in range(len(w)) for j in range(i))
        / np.abs(w).max())
    if max(res["logits_err"], res["probs_err"]) > DDP_ROWS_RTOL or \
            res["separation"] < 10 * DDP_ROWS_RTOL:
        raise AssertionError(f"eval rows differ from one process: {res}")
    return res


def fs_ranks_and_preemption(dev, tmp, tag="13 ddp"):
    """Phase 13(b) and the preemption and viz parts of (c), on the FS
    trainer: one process on the global batch (epoch 0, eval, epoch 1),
    then 2 gloo ranks on the one card, then a child process that a
    SIGTERM ends mid-epoch, resumed here."""
    import signal

    import torch

    from eventclip_tpu_torch import kernels
    from tests.torch_ddp_worker import evaluate_rows

    out = {}
    t0 = time.perf_counter()
    ref = ddp_fs_trainer(dev, os.path.join(tmp, "whole"))
    L = ref.clip_cfg.vision.layers
    kernels.reset_launches()
    ref.train_epoch(0)
    torch.cuda.synchronize()
    one_ms = [s * 1e3 for _, s in ref.step_times]
    ev0, *rows0 = evaluate_rows(ref)
    after3 = trained_leaves(ref)
    ref.train_epoch(1)
    after6 = trained_leaves(ref)
    lr = float(ref.opt_cfg.lr)

    # (c) viz: the GIFs of 5 val items through this trainer's forward
    viz_dir = os.path.join(tmp, "whole", "viz", "epoch_1")
    kernels.reset_launches()
    try:
        import PIL  # noqa: F401
        have_pil = True
    except ImportError:
        have_pil = False
    try:
        ref._sample_events()
    except ImportError:
        if have_pil:
            raise
    torch.cuda.synchronize()
    vp, vi = ref.viz_forwards
    viz_launches = dict(kernels.LAUNCHES)
    if viz_launches != {"histogram": vp + vi, "qkv_attention": L * vp} \
            or vp < 1:
        raise AssertionError(f"viz launches {viz_launches} ({vp}, {vi})")
    if have_pil:
        files = sorted(os.listdir(viz_dir))
        caps = json.load(open(os.path.join(viz_dir, "captions.json")))
        if len(caps) != vp or sum(f.endswith(".gif") for f in files) \
                != vp + vi:
            raise AssertionError(f"viz wrote {files}")
        log(f"[{tag}] (c) viz: {vp} val items, captions.json and "
            f"{vp + vi} GIFs; launches {viz_launches}")
    else:
        log(f"[{tag}] (c) viz: PIL does not import on this machine, so the "
            f"GIFs were NOT checked; the first item's forward ran "
            f"(launches {viz_launches}) and the trainer printed "
            "'[viz] skipped'")
    out["viz"] = dict(items=vp, inputs=vi, launches=viz_launches,
                      gifs_checked=have_pil)
    del ref
    torch.cuda.empty_cache()

    # (b) 2 gloo ranks on the one card
    t1 = time.perf_counter()
    out_dir, recs, leaves = spawn_fs_ranks(dev, tmp)
    ranks_s = time.perf_counter() - t1
    cmp = [compare_leaves(lv, after3, lr * 3) for lv in leaves]
    rank1_files = [os.path.join(dp, f) for dp, _, fs in
                   os.walk(os.path.join(out_dir, "rank1")) for f in fs]
    rank0_files = sorted(os.path.relpath(os.path.join(dp, f),
                                         os.path.join(out_dir, "rank0"))
                         for dp, _, fs in os.walk(os.path.join(out_dir,
                                                               "rank0"))
                         for f in fs)
    two_ms = recs[0]["step_ms"]
    log(f"[{tag}] (b) 2 ranks over {recs[0]['backend']} on "
        f"{recs[0]['device']} / {recs[1]['device']}: this machine has "
        f"{recs[0]['cards']} card(s) and the run used no second card "
        f"(NCCL refuses two ranks on one card); global batch "
        f"{2 * recs[0]['local_batch']}, {recs[0]['local_batch']} a rank; "
        f"steps (ms) rank 0 "
        f"{[round(x, 1) for x in two_ms]}, rank 1 "
        f"{[round(x, 1) for x in recs[1]['step_ms']]} against one process "
        f"{[round(x, 1) for x in one_ms]}; ranks' wall {ranks_s:.1f} s")
    for r, c in enumerate(cmp):
        log(f"[{tag}] (b) rank {r} leaves vs one process: max |diff| "
            f"{c['max_diff']:.3g} off the key bias "
            f"({100 * c['share_above']:.4f}% above {DDP_FS_ATOL}), key bias "
            f"{c['key_bias_max_diff']:.3g} (bound "
            f"{c['key_bias_bound']:.3g}); launches {recs[r]['launches']}")
        if c["share_above"] > DDP_FS_SHARE or \
                c["key_bias_max_diff"] > c["key_bias_bound"] or \
                c["max_diff"] > c["key_bias_bound"]:
            raise AssertionError(f"rank {r}'s leaves differ: {c}")
        if recs[r]["launches"] != {"histogram": 3, "qkv_attention": 3 * L}:
            raise AssertionError(f"rank {r} launches {recs[r]['launches']}")
    for r in (0, 1):
        ev = recs[r]["eval"]
        same = ev["n"] == ev0["n"] and all(
            round(ev[k] * ev["n"]) == round(ev0[k] * ev0["n"])
            for k in ("probs_acc", "logits_acc"))
        if not same or not np.isclose(ev["ce_loss"], ev0["ce_loss"],
                                      rtol=DDP_CE_RTOL, atol=0):
            raise AssertionError(f"rank {r} eval {ev} != one process {ev0}")
    rows = compare_eval_rows(out_dir, rows0)
    log(f"[{tag}] (b) per-sample eval rows, ranks in rank order vs one "
        f"process ({rows['samples']} samples): max |diff| / max |value| "
        f"logits {rows['logits_err']:.3g}, probs {rows['probs_err']:.3g} "
        f"(limit {DDP_ROWS_RTOL}); least distance between two samples' "
        f"logits {rows['separation']:.3g} of max |value| (at least "
        f"{10 * DDP_ROWS_RTOL})")
    if rank1_files:
        raise AssertionError(f"rank 1 wrote {rank1_files}")
    log(f"[{tag}] (b) eval summed over the ranks {recs[0]['eval']} = one "
        f"process {ev0} (CE within {DDP_CE_RTOL}); rank 0 wrote "
        f"{rank0_files}, rank 1 nothing")
    out["ranks"] = dict(step_ms=[r["step_ms"] for r in recs],
                        wait_ms=[r["wait_ms"] for r in recs],
                        one_process_step_ms=one_ms, backend=recs[0]["backend"],
                        compare=cmp, eval=recs[0]["eval"], eval_one=ev0,
                        eval_rows=rows,
                        launches=[r["launches"] for r in recs],
                        wall_s=ranks_s)

    # (c) a SIGTERM mid-epoch in a child process, then the resume here
    child_dir = os.path.join(tmp, "preempted")
    code = (f"import os, signal, sys, time\nsys.path.insert(0, {HERE!r})\n"
            + PREEMPT_CHILD)
    t1 = time.perf_counter()
    res = subprocess.run([sys.executable, "-c", code, child_dir, str(dev)],
                         capture_output=True, text=True, timeout=600)
    child_s = time.perf_counter() - t1
    lines = [json.loads(ln) for ln in
             open(os.path.join(child_dir, "metrics.jsonl"))]
    save_s = [float(ln.split()[1]) for ln in res.stdout.splitlines()
              if ln.startswith("SAVE_S ")]
    if res.returncode != -signal.SIGTERM or \
            [ln["split"] for ln in lines] != ["train", "val", "preempt"] or \
            not os.path.exists(os.path.join(child_dir, "models",
                                            "resume.pt")):
        raise AssertionError(f"preempted child: rc {res.returncode}, lines "
                             f"{lines}\n{res.stdout[-3000:]}"
                             f"\n{res.stderr[-3000:]}")
    resumed = ddp_fs_trainer(dev, child_dir)
    resumed.fit(san_check_val_step=0)
    rcmp = compare_leaves(trained_leaves(resumed), after6, 0.0)
    lines = [json.loads(ln) for ln in
             open(os.path.join(child_dir, "metrics.jsonl"))]
    log(f"[{tag}] (c) SIGTERM at step 2 of epoch 0 in a child: it ended "
        f"by the signal (rc {res.returncode}) after {child_s:.1f} s, the "
        f"forced save took {save_s[0] if save_s else float('nan'):.2f} s; "
        f"resumed here to {resumed.optimizer.count} updates: leaves "
        f"{'bit-equal' if rcmp['bit_equal'] else 'NOT bit-equal'} to the "
        f"uninterrupted run (max |diff| {rcmp['max_diff']:.3g}); metrics "
        f"{[ln['split'] for ln in lines]}, one run_id: "
        f"{len({ln['run_id'] for ln in lines}) == 1}")
    if not rcmp["bit_equal"] or resumed.optimizer.count != 6 or \
            len({ln["run_id"] for ln in lines}) != 1:
        raise AssertionError(f"resume after preemption: {rcmp}")
    out["preempt"] = dict(child_s=child_s, save_s=save_s[0] if save_s
                          else None, rc=res.returncode, bit_equal=True)
    del resumed
    torch.cuda.empty_cache()
    out["wall_s"] = time.perf_counter() - t0
    return out


# the child of phase 13(c): the FS trainer's fit, which sends itself a
# SIGTERM at the second step of epoch 0 and prints the forced save's time
PREEMPT_CHILD = """
import torch
import chip_smoke
t = chip_smoke.ddp_fs_trainer(torch.device(sys.argv[2]), sys.argv[1])
step, save, calls = t.train_step, t.save, [0]

def step_then_signal(batch):
    calls[0] += 1
    if calls[0] == 2:
        os.kill(os.getpid(), signal.SIGTERM)
    return step(batch)

def timed_save(*a):
    t0 = time.perf_counter()
    save(*a)
    torch.cuda.synchronize()
    print(f"SAVE_S {time.perf_counter() - t0}", flush=True)

t.train_step, t.save = step_then_signal, timed_save
t.fit(san_check_val_step=0)
print("fit returned")
"""


def gen_data_ranks(run, tmp, tag="13 ddp"):
    """Phase 13(d): phase 11's FS teacher on two gloo ranks on the card
    (the JAX triple's env). Each child joins the group over gloo itself
    (NCCL refuses two ranks on one GPU); the CLI's own
    initialize_distributed then finds the group. Rank 0's report and tree
    equal phase 11's one-process run; rank 1 prints no report."""
    save = run["save"] + "-ddp"
    port = free_port()
    code = (f"import sys\nsys.path.insert(0, {HERE!r})\n"
            "from eventclip_tpu_torch.cli import gen_data\n"
            "from eventclip_tpu_torch.parallel.distributed import "
            "initialize_distributed\n"
            "initialize_distributed(backend='gloo', device='cuda')\n"
            "gen_data.main(sys.argv[1:])\n")
    procs = []
    t0 = time.perf_counter()
    for rank in (0, 1):
        env = dict(os.environ, JAX_COORDINATOR_ADDRESS=f"localhost:{port}",
                   JAX_NUM_PROCESSES="2", JAX_PROCESS_ID=str(rank))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", code, *run["argv"], "--save_path", save],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=DDP_TIMEOUT_S)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        raise AssertionError(f"gen_data ranks ran past {DDP_TIMEOUT_S} s")
    wall = time.perf_counter() - t0

    def report(text):
        return text[text.index("Class stats:"):
                    text.find("Pseudo-label dataset tree")]

    if any(p.returncode for p in procs):
        raise AssertionError("gen_data ranks failed:\n" + "\n".join(
            o[-3000:] for o in outs))
    same_report = report(outs[0]) == report(run["stdout"])
    same_tree = tree_map(save) == tree_map(run["save"])
    totals = [ln for ln in report(outs[0]).splitlines() if "\tSelect " in ln]
    log(f"[{tag}] (d) cli.gen_data FS teacher on 2 gloo ranks on the card: "
        f"{wall:.1f} s; report {'equal' if same_report else 'DIFFERENT'}, "
        f"tree {'equal' if same_tree else 'DIFFERENT'} to phase 11's one "
        f"process ({totals}); rank 1 printed a report: "
        f"{'Class stats:' in outs[1]}")
    if not (same_report and same_tree) or "Class stats:" in outs[1]:
        raise AssertionError("2-rank gen_data differs from one process")
    return dict(wall_s=wall, report_equal=True, tree_equal=True,
                totals=totals)


def ddp_phase(dev, gen, tmp, fs_teacher_run):
    """Phase 13. Returns the record and the ddp path's kernel rows and
    launches (phase 13(a)'s one-rank NCCL steps)."""
    import torch

    tag = "13 ddp"
    t_phase = time.perf_counter()
    rows = {
        "histogram": check_histogram(gen, "ddp FT batch 32", 64, 70000, 480,
                                     640, dev),
        "qkv_attention": check_attention(
            gen, "ddp FT batch 32", 64, 257, 16, 64, torch.bfloat16,
            False, dev),
        "qkv_attention_bwd": check_attention_bwd(
            gen, "ddp FT batch 32", 64, 257, 16, 64, torch.bfloat16,
            False, dev)}
    d = os.path.join(tmp, "ddp")
    os.makedirs(d)
    out = {"nccl": nccl_one_rank(dev, d)}
    out.update(fs_ranks_and_preemption(dev, d))
    out["gen_data"] = gen_data_ranks(fs_teacher_run, tmp)
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[{tag}] phase 13 in {out['phase_s']:.1f} s")
    return out, rows, out["nccl"]["launches"]

# -- phase 14: ZeRO-1, tensor parallelism, data-parallel serving ------------

# 14(a)/(b): ranks against one process, bf16 FT at ViT-L/14 after 3 steps
# (and the resumed 4th), element by element over the trained f32 leaves.
# The ranks' GEMMs see other shapes (half the heads, half the batch), so
# their bf16 roundings differ and an element whose gradient is near zero
# may flip Adam's step (about lr whatever the gradient's size): all but
# a share TP_SHARE of the elements within TP_ATOL_LR x lr (the largest
# difference is printed, not bounded: Adam moves an element by about lr a
# step whatever its gradient, so no per-element bound below 2 lr a step
# can tell a fault). On an H100 sound runs read shares of 1.3-1.6% (TP)
# and 0.84% (2 data ranks, no TP); a rank that skips the row-parallel sum
# read 65%, in a CPU rehearsal at ViT-T/8@32 in bf16 (where the sound
# share is under 1e-4), not on the card.
TP_ATOL_LR = 0.05
TP_SHARE = 0.05
TP_TIMEOUT_S = 420  # a hung rendezvous fails the phase, not the call
# 14(c): the split over [cuda:0, cuda:0] against one part: each valid
# view's feature norm-relative within DP_SERVE_REL (sound runs on an H100
# read 1.58e-7), while any two views of different samples lie at least
# ten times that apart (else views put back in the wrong order would
# pass); the probabilities within DP_SERVE_PROBS_ATOL
DP_SERVE_REL = 1e-5
DP_SERVE_PROBS_ATOL = 1e-4


class CommClock:
    """Wall time and bytes of the host collectives a rank's process group
    runs (gloo: CUDA tensors are staged through the host around them)."""

    def __init__(self):
        import torch.distributed as dist

        self.ms, self.bytes, self.calls = 0.0, 0, 0
        for name in ("all_reduce", "all_gather"):
            real = getattr(dist, name)

            def timed(*a, _real=real, **k):
                t = a[0]
                n = (sum(x.numel() * x.element_size() for x in t)
                     if isinstance(t, list) else t.numel() * t.element_size())
                t0 = time.perf_counter()
                out = _real(*a, **k)
                self.ms += (time.perf_counter() - t0) * 1e3
                self.bytes += n
                self.calls += 1
                return out
            setattr(dist, name, timed)

    def reset(self):
        self.ms, self.bytes, self.calls = 0.0, 0, 0


def tp_rank(rank, port, out_dir, device):
    """One of phase 14's two gloo ranks on the one card (a spawned
    process): K2 / K3 at this rank's tensor-parallel shape against their
    plain versions, then 3 FT steps on each layout (2 data ranks, 2 data
    ranks with ZeRO-1, 1 x 2 tensor-parallel); the ZeRO-1 run writes its
    resume.pt and takes a 4th step. Writes its record (and, rank 0, the
    gathered leaves) under out_dir."""
    import torch

    sys.path.insert(0, HERE)
    from eventclip_tpu_torch import kernels
    from eventclip_tpu_torch.engine.checkpoint import trainable_flat
    from eventclip_tpu_torch.parallel import distributed as D

    D.initialize_distributed(f"localhost:{port}", 2, rank, backend="gloo",
                             device=device)
    dev = torch.device(device)
    clock = CommClock()
    gen = torch.Generator(device=dev).manual_seed(10 + rank)
    rec = {"check": {
        "qkv_attention": check_attention(
            gen, f"TP rank {rank}", 16, 257, 8, 64, torch.bfloat16, False,
            dev),
        "qkv_attention_bwd": check_attention_bwd(
            gen, f"TP rank {rank}", 16, 257, 8, 64, torch.bfloat16, False,
            dev)}}

    def save_leaves(tr, name):
        flat = trainable_flat(tr.cls_cfg, tr.model_params)  # a collective
        if rank == 0:
            torch.save({k: torch.from_numpy(v) for k, v in flat.items()},
                       os.path.join(out_dir, f"{name}.pt"))

    for name, n_model, zero1 in (("dp", 1, False), ("zero1", 1, True),
                                 ("tp", 2, False)):
        tr = ft_ddp_trainer(dev, os.path.join(out_dir, name), 8,
                            n_model=n_model, zero1=zero1)
        torch.cuda.synchronize()
        clock.reset()
        # this path's run: counts zeroed just before, read just after
        # each step's allocator peak (kept on the host: no sync added)
        peaks = []

        def peaked(batch, _step=tr.train_step):
            torch.cuda.reset_peak_memory_stats()
            out = _step(batch)
            peaks.append(torch.cuda.max_memory_allocated())
            return out
        tr.train_step = peaked
        kernels.reset_launches()
        tr.train_epoch(0)
        torch.cuda.synchronize()
        steps = len(tr.step_times)
        r = dict(launches=dict(kernels.LAUNCHES),
                 step_ms=[st * 1e3 for _, st in tr.step_times],
                 wait_ms=[w * 1e3 for w, _ in tr.step_times],
                 comm_ms=clock.ms / steps, comm_bytes=clock.bytes / steps,
                 comm_calls=clock.calls / steps,
                 moment_bytes=tr.optimizer.moment_bytes(),
                 # each step's peak and what the rank holds after them
                 # (weights, moments, the last gradients)
                 peak_bytes=list(peaks),
                 held_bytes=torch.cuda.memory_allocated(),
                 param_bytes=sum(p.numel() * p.element_size()
                                 for p in tr.model_params.parameters()),
                 layout=[tr.n_data, tr.n_model],
                 local_batch=tr.train_loader.local_batch,
                 zero1=tr.zero1)
        save_leaves(tr, name)
        if name == "zero1":
            t0 = time.perf_counter()
            tr.ckpt.save_resume_state(tr.model_params, tr.optimizer, 1)
            r["resume_write_s"] = time.perf_counter() - t0
            nxt = tr.device_batch(next(iter(tr.train_loader.epoch(1))))
            tr.train_step(nxt)
            torch.cuda.synchronize()
            save_leaves(tr, "zero1_next")
        rec[name] = r
        del tr
        torch.cuda.empty_cache()
    rec["backend"] = torch.distributed.get_backend()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(rec, f)
    D.shutdown_distributed()


def spawn_tp_ranks(dev, out_dir):
    import torch.multiprocessing as mp

    ctx = mp.start_processes(tp_rank, args=(free_port(), out_dir, str(dev)),
                             nprocs=2, join=False, start_method="spawn")
    deadline = time.monotonic() + TP_TIMEOUT_S
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise AssertionError(f"the 2 ranks did not finish within "
                                 f"{TP_TIMEOUT_S} s")
    return [json.load(open(os.path.join(out_dir, f"rank{r}.json")))
            for r in (0, 1)]


def leaf_gap(got, want, lrs):
    """{JAX path: tensor} against {JAX path: tensor}: the largest |diff|
    (also in units of its leaf's lr) and the share of elements above
    TP_ATOL_LR x lr; `lrs` is (lr, clip_lr): the visual tower's leaves
    move by clip_lr, the others (the prompts) by lr."""
    import torch

    above = n = 0
    worst = worst_lr = 0.0
    for k, w in want.items():
        lr = lrs[1] if k.startswith(("clip/visual", "lora")) else lrs[0]
        d = (got[k].double() - w.double()).abs()
        worst = max(worst, float(d.max()))
        worst_lr = max(worst_lr, float(d.max()) / lr)
        above += int((d > TP_ATOL_LR * lr).sum())
        n += d.numel()
    return dict(max_diff=worst, max_diff_lr=worst_lr,
                share_above=above / max(n, 1), bound_atol_lr=TP_ATOL_LR,
                bound_share=TP_SHARE,
                bit_equal=all(torch.equal(got[k], want[k]) for k in want))


def off_bound(gap):
    return gap["share_above"] > gap["bound_share"]


def flat_leaves(trainer):
    import torch

    from eventclip_tpu_torch.engine.checkpoint import trainable_flat

    return {k: torch.from_numpy(v) for k, v in
            trainable_flat(trainer.cls_cfg, trainer.model_params).items()}


def tp_zero1_phase(dev, tmp, tag="14 tp/zero1"):
    """14(a) and (b): one process on the card, then two gloo ranks on the
    card (NCCL refuses two ranks on one GPU), then one process resumed
    from the ranks' ZeRO-1 resume.pt."""
    import torch

    from eventclip_tpu_torch import kernels

    out_dir = os.path.join(tmp, "tp")
    os.makedirs(out_dir)
    t0 = time.perf_counter()
    one = ft_ddp_trainer(dev, os.path.join(out_dir, "one"), 8)
    kernels.reset_launches()
    one.train_epoch(0)
    torch.cuda.synchronize()
    one_ms = [st * 1e3 for _, st in one.step_times]
    one_launches = dict(kernels.LAUNCHES)
    want = flat_leaves(one)
    one_moments = one.optimizer.moment_bytes()
    one_param_bytes = sum(p.numel() * p.element_size()
                          for p in one.model_params.parameters())
    lr = (float(one.opt_cfg.lr), float(one.opt_cfg.clip_lr))
    L = one.clip_cfg.vision.layers
    del one
    torch.cuda.empty_cache()
    one_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    recs = spawn_tp_ranks(dev, out_dir)
    ranks_s = time.perf_counter() - t0
    got = {n: torch.load(os.path.join(out_dir, f"{n}.pt"))
           for n in ("dp", "zero1", "tp", "zero1_next")}
    out = {"one_step_ms": one_ms, "one_launches": one_launches,
           "one_param_bytes": one_param_bytes, "one_moment_bytes":
           one_moments, "ranks": recs, "one_s": one_s, "ranks_s": ranks_s}
    steps = len(one_ms)
    expect = {"histogram": steps, "qkv_attention": 2 * L * steps,
              "qkv_attention_bwd": L * steps}
    for r, rec in enumerate(recs):
        for name in ("dp", "zero1", "tp"):
            if rec[name]["launches"] != expect:
                raise AssertionError(f"rank {r} {name} launches "
                                     f"{rec[name]['launches']} != {expect}")
    tp0, tp1 = recs[0]["tp"], recs[1]["tp"]
    out["tp"] = leaf_gap(got["tp"], want, lr)
    out["dp"] = leaf_gap(got["dp"], want, lr)
    comm = statistics.median([tp0["comm_ms"], tp1["comm_ms"]])
    step = statistics.median(tp0["step_ms"])
    log(f"[{tag}] (a) TP FT ViT-L/14 bf16 remat RandAugment, batch 8 x 2 "
        f"views, 1 x 2 layout: 2 ranks share the one card over "
        f"{recs[0]['backend']} (NCCL refuses two ranks on one GPU, so each "
        f"model-group sum goes card -> host -> card): step "
        f"{[round(x, 1) for x in tp0['step_ms']]} ms (median {step:.1f}; "
        f"one process {statistics.median(one_ms):.1f}), of which host "
        f"collectives {tp0['comm_ms']:.1f} ms in {tp0['comm_calls']:.0f} "
        f"calls moving {tp0['comm_bytes'] / 2**20:.0f} MiB a step; "
        f"parameter bytes a rank {tp0['param_bytes'] / 2**30:.3f} GiB vs "
        f"one process {one_param_bytes / 2**30:.3f} GiB; launches a rank "
        f"{tp0['launches']} (rank 1 {tp1['launches']}); leaves vs one "
        f"process: max |diff| {out['tp']['max_diff']:.3g} = "
        f"{out['tp']['max_diff_lr']:.3g} lr, share "
        f"above {TP_ATOL_LR} lr {out['tp']['share_above']:.2e} (<= "
        f"{TP_SHARE}); the 2 data ranks' (no TP) read max "
        f"{out['dp']['max_diff_lr']:.3g} lr, share "
        f"{out['dp']['share_above']:.2e}")
    out["tp_comm_share"] = comm / step
    # (b) ZeRO-1 against the replicated update, on 2 data ranks
    bit = all(torch.equal(got["zero1"][k], got["dp"][k]) for k in got["dp"])
    diff = max(float((got["zero1"][k].double() - got["dp"][k].double())
                     .abs().max()) for k in got["dp"])
    z, d = recs[0]["zero1"], recs[0]["dp"]
    out["zero1"] = dict(bit_equal=bit, max_diff=diff,
                        moment_bytes=z["moment_bytes"],
                        replicated_moment_bytes=d["moment_bytes"],
                        peak_bytes=z["peak_bytes"],
                        replicated_peak_bytes=d["peak_bytes"],
                        held_bytes=z["held_bytes"],
                        replicated_held_bytes=d["held_bytes"])
    log(f"[{tag}] (b) ZeRO-1 on 2 data ranks (batch 4 a rank): leaves "
        f"{'bit-equal' if bit else 'NOT bit-equal'} to the replicated "
        f"update (max |diff| {diff:.3g}); Adam moments a rank "
        f"{z['moment_bytes'] / 1e9:.3f} GB on vs {d['moment_bytes'] / 1e9:.3f}"
        f" GB off (one process {one_moments / 1e9:.3f} GB); card memory a "
        f"rank (torch's allocator, rank 0) at each step's peak "
        f"{[round(b / 1e9, 3) for b in z['peak_bytes']]} GB on vs "
        f"{[round(b / 1e9, 3) for b in d['peak_bytes']]} GB off, held "
        f"after the steps {z['held_bytes'] / 1e9:.3f} vs "
        f"{d['held_bytes'] / 1e9:.3f} GB; step "
        f"{statistics.median(z['step_ms']):.1f} ms on vs "
        f"{statistics.median(d['step_ms']):.1f} ms off (host collectives "
        f"{z['comm_ms']:.1f} vs {d['comm_ms']:.1f} ms a step); resume.pt "
        f"written in {z['resume_write_s']:.1f} s")
    faults = [f"{k} leaves off the bound: {out[k]}" for k in ("tp", "dp")
              if off_bound(out[k])]
    if not bit and diff > 0:
        # torch's Adam updates elementwise: a slice's update is the whole
        # leaf's on those elements; a difference is a fault
        faults.append(f"ZeRO-1 differs from the replicated update by "
                      f"{diff}")
    # one process resumed from the ZeRO-1 file takes the 4th step
    t0 = time.perf_counter()
    res = ft_ddp_trainer(dev, os.path.join(out_dir, "zero1"), 8)
    epoch = res.ckpt.load_resume_state(res.model_params, res.optimizer)
    load_s = time.perf_counter() - t0
    same = all(torch.equal(flat_leaves(res)[k], got["zero1"][k])
               for k in got["zero1"])
    nxt = res.device_batch(next(iter(res.train_loader.epoch(1))))
    res.train_step(nxt)
    torch.cuda.synchronize()
    out["resume"] = leaf_gap(flat_leaves(res), got["zero1_next"], lr)
    out["resume"].update(epoch=epoch, count=res.optimizer.count,
                         leaves_equal=same, load_s=load_s)
    log(f"[{tag}] (b) resume.pt written under ZeRO-1 (whole leaves and "
        f"moments) resumed by one process in {load_s:.1f} s: epoch {epoch},"
        f" count {res.optimizer.count - 1} before its step, leaves "
        f"{'bit-equal' if same else 'NOT equal'} to the ranks'; its next "
        f"step vs the ranks' max |diff| {out['resume']['max_diff']:.3g} = "
        f"{out['resume']['max_diff_lr']:.3g} lr, share above {TP_ATOL_LR} "
        f"lr {out['resume']['share_above']:.2e}")
    if not same or epoch != 1:
        faults.append("the ZeRO-1 resume.pt did not restore the ranks' "
                      "state")
    if off_bound(out["resume"]):
        faults.append(f"the resumed step off the bound: {out['resume']}")
    del res
    torch.cuda.empty_cache()
    if faults:
        raise AssertionError("; ".join(faults))
    return out


def dp_serve_phase(dev, params, names, text_feats, ref, tag="14 dp serve"):
    """14(c): Predictor(data_parallel=True) on the one card (one part)
    and over [cuda:0, cuda:0] (two), against phase 3's request."""
    import torch

    from eventclip_tpu_torch import kernels
    from eventclip_tpu_torch.models.clip.config import clip_arch_config
    from eventclip_tpu_torch.models.clip.model import init_clip_params
    from eventclip_tpu_torch.serve import Predictor

    clip_cfg = clip_arch_config(params.clip_dict["arch"])
    clip = init_clip_params(clip_cfg, torch.Generator(device=dev)
                            .manual_seed(0), device=dev)  # phase 3's towers
    wins, valids = ref["wins"], ref["valids"]
    L = clip_cfg.vision.layers
    out = {}
    for label, devices in (("one card", None), ("[cuda:0, cuda:0]",
                                                 [dev, dev])):
        pred = Predictor(params, names, clip_params=clip,
                         text_feats=text_feats, batch_size=32, device=dev,
                         data_parallel=True, devices=devices)
        pred.warm_up()
        times = []
        kernels.reset_launches()
        for _ in range(3):
            t0 = time.perf_counter()
            probs = pred.predict_windows(wins, valids, top_k=5)["probs"]
            times.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        launches = {k: v // 3 for k, v in kernels.LAUNCHES.items()}
        batch = pred._place_chunk(wins[:32], valids[:32])
        feats = pred._forward(batch)["view_feats"].float()
        r = dict(parts=pred._split.n, ms=statistics.median(times),
                 launches=launches, views=int(batch["windows"].shape[0]),
                 bit_equal=bool(np.array_equal(probs, ref["probs"])),
                 max_abs_diff=float(np.abs(probs - ref["probs"]).max()))
        # K1 once a part, K2 once a block a part, a request
        expect = {"histogram": r["parts"], "qkv_attention": r["parts"] * L}
        if launches != expect:
            raise AssertionError(f"{label}: launches a request {launches} "
                                 f"!= {expect}")
        valid = batch["valid_mask"].bool()
        if devices is None:
            ref_feats, ref_probs = feats, probs
            if not r["bit_equal"]:
                raise AssertionError(f"data_parallel=True on one card "
                                     f"differs from phase 3: {r}")
            # how far apart views of different samples lie
            f = feats[valid]
            sample = torch.arange(valid.shape[0], device=f.device)[
                :, None].expand_as(valid)[valid]
            gap = torch.cdist(f.double(), f.double()) / \
                f.double().norm(dim=-1, keepdim=True).clamp_min(1e-30)
            gap[sample[:, None] == sample[None, :]] = float("inf")
            r["separation"] = float(gap.min())
        else:
            num = (feats - ref_feats).norm(dim=-1)
            den = ref_feats.norm(dim=-1).clamp_min(1e-30)
            r["feature_rel"] = float((num / den)[valid].max())
            r["probs_vs_one_part"] = float(np.abs(probs - ref_probs).max())
            sep = out["one card"]["separation"]
            if r["feature_rel"] > DP_SERVE_REL or \
                    sep < 10 * DP_SERVE_REL or \
                    r["probs_vs_one_part"] > DP_SERVE_PROBS_ATOL:
                raise AssertionError(
                    f"the split over two parts: {r}; views of different "
                    f"samples {sep:.3g} apart (norm-relative)")
        out[label] = r
        log(f"[{tag}] (c) Predictor(data_parallel=True) {label}: "
            f"{r['parts']} part(s), request 32 x 225k {r['ms']:.1f} ms "
            f"median of 3 (phase 3 {ref['ms']:.1f} ms, host windowing "
            f"included there); launches a request {launches}; probs "
            f"{'bit-equal' if r['bit_equal'] else 'not bit-equal'} to phase "
            f"3's (max |diff| {r['max_abs_diff']:.3g})" +
            (f"; views of different samples at least "
             f"{r['separation']:.3g} apart, norm-relative (>= "
             f"{10 * DP_SERVE_REL})" if "separation" in r else "") +
            (f"; view features vs one part, norm-relative max "
             f"{r['feature_rel']:.3g} (<= {DP_SERVE_REL}), probs max |diff| "
             f"{r['probs_vs_one_part']:.3g} (<= {DP_SERVE_PROBS_ATOL})"
             if "feature_rel" in r else ""))
        del pred
        torch.cuda.empty_cache()
    return out


def parallel_phase(dev, gen, tmp, params, names, text_feats, ref):
    """Phase 14. Returns the record, the kernel rows of the tp, zero1 and
    dp_serve paths, and each path's launches (rank 0's, and the split
    request's)."""
    import torch

    t_phase = time.perf_counter()
    rows = {
        "tp": {"histogram": check_histogram(gen, "TP FT batch 8", 16, 70000,
                                            480, 640, dev),
               "qkv_attention": check_attention(
                   gen, "TP FT batch 8, a rank", 16, 257, 8, 64,
                   torch.bfloat16, False, dev),
               "qkv_attention_bwd": check_attention_bwd(
                   gen, "TP FT batch 8, a rank", 16, 257, 8, 64,
                   torch.bfloat16, False, dev)},
        "zero1": {"histogram": check_histogram(gen, "ZeRO-1 FT batch 4", 8,
                                               70000, 480, 640, dev),
                  "qkv_attention": check_attention(
                      gen, "ZeRO-1 FT batch 4", 8, 257, 16, 64,
                      torch.bfloat16, False, dev),
                  "qkv_attention_bwd": check_attention_bwd(
                      gen, "ZeRO-1 FT batch 4", 8, 257, 16, 64,
                      torch.bfloat16, False, dev)}}
    out = {"train": tp_zero1_phase(dev, tmp)}
    dp = dp_serve_phase(dev, params, names, text_feats, ref)
    out["serve"] = dp
    half = dp["[cuda:0, cuda:0]"]["views"] // 2
    rows["dp_serve"] = {
        "histogram": check_histogram(gen, "split serving, a part", half,
                                     20000, 180, 240, dev),
        "qkv_attention": check_attention(
            gen, "split serving, a part", half, 257, 16, 64,
            torch.bfloat16, False, dev)}
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[14 parallel] phase 14 in {out['phase_s']:.1f} s")
    launches = {"tp": out["train"]["ranks"][0]["tp"]["launches"],
                "zero1": out["train"]["ranks"][0]["zero1"]["launches"],
                "dp_serve": dp["[cuda:0, cuda:0]"]["launches"]}
    return out, rows, launches


# -- phase 15: the port's converters and real-asset parity harness ---------


def parity_phase(dev, files, tmp, tag="15 parity"):
    """Phase 15: the port's parity harness (cli.parity_check, in process)
    on the card at ViT-L/14, on phase 9's fp16 `.pt`, tree and exported
    best.pth, with no BPE vocab to be found (EVENTCLIP_BPE_PATH unset): it
    must return 0 with both towers within 2e-3 of the torch oracle, the
    method eval ok and the few-shot `.pth` round trip bit-equal, the
    asset-gated stages (tokenizer, zero-shot) skipped with their notes.
    The counts are zeroed just before and read just after: K1 and K2 must
    have run (the towers in f32, the evals; the K-shot training is a
    subprocess of its own). Returns the phase's record and its launches."""
    import torch

    from eventclip_tpu_torch import kernels
    from eventclip_tpu_torch.cli import parity_check

    out_json = os.path.join(tmp, "PARITY_RESULT.json")
    argv = ["--clip_ckpt", files["pt"], "--data_root", files["tree"],
            "--npz_out", os.path.join(tmp, "parity.npz"), "--out", out_json,
            "--method_ckpt", files["pth"], "--method_params", files["fs"],
            "--fs_shots", "2", "--fs_epochs", "1", "--fs_roundtrip",
            "--fs_params", files["fs"],
            "--workdir", os.path.join(tmp, "parity_fs")]
    kernels.reset_launches()
    t0 = time.perf_counter()
    rc = parity_check.main(argv)
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    # set by the harness for the prompt-tuned config (its text features
    # load from the checkpoint)
    os.environ.pop("EVENTCLIP_ALLOW_RANDOM_TEXT", None)
    with open(out_json) as f:
        res = json.load(f)
    stages = {"tower_parity": res["tower_parity"],
              "tokenizer": res["tokenizer"], "zero_shot": res["zero_shot"],
              "method_eval": res["method_evals"][0],
              "few_shot": res["few_shot"]}
    walls = {k: v.get("wall_s", 0.0) for k, v in stages.items()}
    for k, v in stages.items():
        log(f"[{tag}] {k}: ok {v['ok']} in {walls[k]:.1f} s"
            + (f" ({v['note']})" if v.get("note") else "")
            + (f"; error {v['error'][:300]}" if v.get("error") else ""))
    towers, fs = res["tower_parity"], res["few_shot"]
    out = dict(rc=rc, wall_s=wall, convert_s=wall - sum(walls.values()),
               stage_s=walls, launches=launches,
               image_max_abs_diff=towers.get("image_max_abs_diff"),
               text_max_abs_diff=towers.get("text_max_abs_diff"),
               method_probs_top1=stages["method_eval"].get("probs_top1"),
               few_shot_probs_top1=fs.get("probs_top1"),
               roundtrip=fs.get("roundtrip"))
    log(f"[{tag}] cli.parity_check returned {rc} in {wall:.1f} s "
        f"(conversion {out['convert_s']:.1f} s); towers vs the oracle "
        f"image {out['image_max_abs_diff']}, text "
        f"{out['text_max_abs_diff']} (tol 2e-3, f32 on the card); method "
        f"eval probs top-1 {out['method_probs_top1']}; 2-shot run probs "
        f"top-1 {out['few_shot_probs_top1']}, .pth round trip "
        f"{(fs.get('roundtrip') or {}).get('bit_equal')}; launches "
        f"{launches}")
    if rc != 0 or res["ok"] is not True:
        raise AssertionError(f"parity harness failed ({rc}): {res}")
    if not (towers["ok"] is True and towers["image_max_abs_diff"] < 2e-3
            and towers["text_max_abs_diff"] < 2e-3):
        raise AssertionError(f"tower parity {towers}")
    if res["tokenizer"]["ok"] is not None or res["zero_shot"]["ok"] \
            is not None:
        raise AssertionError("an asset-gated stage ran without the vocab")
    if stages["method_eval"]["ok"] is not True:
        raise AssertionError(f"method eval {stages['method_eval']}")
    if not (fs["ok"] is True and fs["roundtrip"]["bit_equal"] is True):
        raise AssertionError(f"few-shot leg {fs}")
    for k in ("histogram", "qkv_attention"):
        if launches.get(k, 0) <= 0:
            raise AssertionError(f"the parity harness never launched {k}")
    return out, launches


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
    from eventclip_tpu_torch import kernels, native
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
           "cli": {}, "none": {}}
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
    # RN50's text tower (phase 11): width 512, 8 heads
    rec["rn50"] = {"qkv_attention": check_attention(
        gen, "text RN50", 101, 77, 8, 64, torch.float32, True, dev)}
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
    # the timed requests, so they hold these requests' launches only (the
    # host half's calls into the native library too)
    if not native.available():
        raise AssertionError("the native host-ops library did not build or "
                             f"load: {native.load_error()}")
    kernels.reset_launches()
    native.reset_calls()
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
    native_calls = dict(native.CALLS)
    log(f"[3 main path] launches over the 9 timed requests {launches}; "
        f"native host-ops calls {native_calls}")
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
    # phase 14(c) serves phase 3's first request again: its windows and
    # phase 3's answer, kept on the host
    wins, valids = pred.gather_windows(requests[0][1])
    dp_ref = dict(wins=wins, valids=valids,
                  probs=pred.predict_windows(wins, valids, top_k=5)["probs"],
                  ms=per_request[requests[0][0]]["ms"])

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

    # -- 9, 10, 11 -------------------------------------------------------
    # phases 10 and 11 run on phase 9's files: one temporary directory
    with tempfile.TemporaryDirectory() as tmp:
        data, rec["cli"], files = data_to_accuracy(dev, gen, tmp)
        options, pruned_row, pruned_launches = serving_options(
            dev, gen, pred, clip, text_feats, names, requests[0][1],
            native_calls, files, data["trained_eval"])
        # phase 12 runs here, on phase 3's predictor and phase 9's files;
        # it swaps pred's labels, which nothing after it reads
        served = server_and_export(dev, pred, requests[0][1], files, tmp)
        del pred, cpu_pred, clip
        torch.cuda.empty_cache()
        pseudo, rn50_launches = pseudo_labels(dev, requests[0][1], files,
                                              tmp)
        # -- 13 -----------------------------------------------------------
        ddp, rec["ddp"], ddp_launches = ddp_phase(
            dev, gen, tmp, pseudo.pop("fs_teacher_run"))
        # -- 14 -----------------------------------------------------------
        parallel, rows14, launches14 = parallel_phase(
            dev, gen, tmp, params, names, text_feats, dp_ref)
        rec.update(rows14)
        # -- 15 -----------------------------------------------------------
        # the harness on phase 9's files, with no vocab on its paths
        os.environ.pop("EVENTCLIP_BPE_PATH")
        parity, parity_launches = parity_phase(dev, files, tmp)
    rec["serve_pruned"] = {"qkv_attention": pruned_row}
    # the harness's evals run the eval CLI's shapes
    rec["parity"] = rec["cli"]
    # the bundle's request: K1 and K2 at phase 3's serving shapes, their
    # device ms a launch from its profile; the bound is the shape's
    rec["export"] = {
        k: dict(shape=rec["serve"][k]["shape"],
                ms=served["export"]["kernel_ms"][k],
                bound_ms=rec["serve"][k]["bound_ms"],
                bound_by=rec["serve"][k]["bound_by"])
        for k in ("histogram", "qkv_attention")}

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
              "train_f32": train32_launches, "train_fs": train_fs_launches,
              "cli": data["eval_cli"]["launches"],
              "serve_pruned": pruned_launches, "rn50": rn50_launches,
              "export": served["export"]["launches"], "ddp": ddp_launches,
              "parity": parity_launches, **launches14}
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
        "train_f32": train32, "train_fs": train_fs, "randaugment": augment,
        "serve_options": options, "pseudo_labels": pseudo,
        "server_export": served, "ddp": ddp, "parallel": parallel,
        "parity": parity, **data}
    log(json.dumps(line))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
