#!/usr/bin/env python3
"""Drive the PyTorch port's zero-shot serving path on one CUDA card.

    python3 chip_smoke.py

Phases (each prints its lines; any failure raises, so the exit code is
non-zero):

1. device: the card's name and power limit, torch / CUDA versions; build
   every CUDA kernel from eventclip_tpu_torch/csrc (one nvcc per source, all
   at once).
2. kernels vs plain on the card, at the main path's shapes: the event
   histogram (exact) on N-Caltech / N-Cars / N-ImageNet geometries, the
   fused-qkv attention on the ViT-L/14 (bf16, no mask), text tower (f32,
   causal mask) and tiny-tower (dh 32 / 16) shapes. Each prints kernel ms,
   plain ms, the bound and one library call's ms as a yardstick.
3. main path: configs/zsclip/zsclip_ncaltech_params.py through the port's
   loader, random ViT-L/14 towers from a seeded generator, text features
   for 101 synthetic prompts through the text tower, a Predictor at
   batch 32 answering requests of 32 x 225k, 8 x 30-60k and 1 x 5k events,
   three times each. Launch counters are zeroed just before these timed
   requests and read just after them (the text tower's and the warm-up's
   counts are printed apart); then one request is profiled.
4. whole path card vs CPU: one short stream through the same towers on the
   CPU (float32, plain kernels); cosine of the view features.

Then one JSON line with every kernel's numbers, the card's name and power
limit, and as the last line {"ok": true, "device": {...}}. Imports nothing
of JAX. Fails when no CUDA device is present or the port is missing.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # dense, per dtype
ATOL = {"float32": 1e-5, "bfloat16": 2e-2}  # kernel vs plain, see PERF.md


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


def synth_windows(gen, M, N, H, W, dev):
    """Packed int16 [M, N, 3] windows with out-of-bounds and p == 0 rows."""
    import torch

    x = torch.randint(-20, W + 20, (M, N), generator=gen, device=dev)
    y = torch.randint(-20, H + 20, (M, N), generator=gen, device=dev)
    p = torch.randint(-1, 2, (M, N), generator=gen, device=dev)
    return torch.stack([x, y, p], dim=-1).to(torch.int16).contiguous()


def check_histogram(gen, name, M, N, H, W, dev):
    import torch

    from eventclip_tpu_torch.ops import numpy_ref
    from eventclip_tpu_torch.ops.rasterize import histograms, histograms_plain

    wins = synth_windows(gen, M, N, H, W, dev)
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
    log(f"K1 histogram {name} [{M}, {N}, 3] int16 @ {H}x{W}: exact; "
        f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bincount "
        f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms (bytes)")
    return dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by="bytes", library_ms=library_ms)


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
    err = float((got.float() - want.float()).abs().max())
    tname = str(dtype).split(".")[-1]
    if not err <= ATOL[tname]:
        raise AssertionError(
            f"attention {name}: max |kernel - plain| {err} > {ATOL[tname]}")

    q, k, v = (t.reshape(B, S, heads, dh).transpose(1, 2).contiguous()
               for t in qkv.split(D, -1))
    ms = cuda_ms(lambda: fused_qkv_attention(qkv, heads, mask))
    plain_ms = cuda_ms(lambda: qkv_attention_plain(qkv, heads, mask))
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=causal))
    esize = qkv.element_size()
    nbytes = (B * S * 3 * D + B * S * D) * esize + (S * S * 4 if causal else 0)
    flops = 4 * B * heads * S * S * dh
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[tname] * 1e3
    bound_ms, bound_by = max((t_bytes, "bytes"), (t_ops, "operations"))
    log(f"K2 attention {name} [{B}, {S}, {3 * D}] {tname} heads={heads} "
        f"dh={dh} mask={'causal' if causal else 'none'}: max_abs_err {err:.3g}"
        f" (atol {ATOL[tname]}); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms,"
        f" sdpa {library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms)


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


def profile_request(pred, label, streams):
    """Device time by kernel over one request (torch.profiler), and the
    device's busy share of the request's wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pred.predict(streams)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for evt in prof.key_averages():
        if getattr(evt, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        rows.append((us / 1e3, evt.count, evt.key))
    if not rows:
        log(f"[3 profile] request {label}: the profiler saw no device "
            "time; device breakdown not measured")
        return
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    log(f"[3 profile] request {label}: wall {wall_ms:.1f} ms, device busy "
        f"{busy:.1f} ms ({100 * busy / wall_ms:.1f}%), idle "
        f"{100 * (1 - busy / wall_ms):.1f}%")
    for ms, count, key in rows[:12]:
        log(f"[3 profile]   {ms:9.3f} ms  {100 * ms / busy:5.1f}%  x{count:<5d}"
            f" {key[:90]}")


def check_probs(out, n, n_cls):
    probs = out["probs"]
    assert probs.shape == (n, n_cls), probs.shape
    assert np.isfinite(probs).all(), "non-finite probs"
    assert np.allclose(probs.sum(-1), 1.0, atol=1e-3), probs.sum(-1)


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
    rec = {}
    rec["histogram"] = check_histogram(gen, "N-Caltech", 320, 20000, 180, 240,
                                       dev)
    check_histogram(gen, "N-Cars", 32, 30000, 100, 120, dev)
    check_histogram(gen, "N-ImageNet", 64, 70000, 480, 640, dev)
    rec["qkv_attention"] = check_attention(
        gen, "ViT-L/14", 320, 257, 16, 64, torch.bfloat16, False, dev)
    text = check_attention(gen, "text ViT-L/14", 101, 77, 12, 64,
                           torch.float32, True, dev)
    check_attention(gen, "ViT-T/8@32", 80, 17, 2, 32, torch.float32, False,
                    dev)
    check_attention(gen, "ViT-T/8@32 bf16", 80, 17, 2, 32, torch.bfloat16,
                    False, dev)
    check_attention(gen, "text ViT-T/8@32", 101, 77, 2, 16, torch.float32,
                    True, dev)

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
    profile_request(pred, *requests[0])

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

    sources = {
        "histogram": ("eventclip_tpu_torch/csrc/histogram.cu",
                      "eventclip_tpu/ops/rasterize.py:123"),
        "qkv_attention": ("eventclip_tpu_torch/csrc/attention.cu",
                          "eventclip_tpu/ops/attention.py:325"),
    }
    line = {"kernels": [
        dict(name=k, route="cuda", source=sources[k][0],
             replaces=sources[k][1], launches=launches[k], **rec[k])
        for k in ("histogram", "qkv_attention")
    ], "text_attention": text, "requests": per_request}
    log(json.dumps(line))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
