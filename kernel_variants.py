#!/usr/bin/env python3
"""Time the shape choices of three CUDA kernels on one card.

    python3 kernel_variants.py [forward] [backward] [histogram]

(no argument: all three)

- The f32 attention forward (csrc/attention.cu, attention_f32_kernel):
  builds of the source with -DF32_ROWS (query rows a block, 16 .. 96),
  -DF32_MIN_BLOCKS=1 (one block an SM, so more registers a thread) and
  -DF32_UNROLL=1 (the inner loops not unrolled), against the default
  build, at the text tower's [101, 77, 2304] causal shape, [8, 257, 3072]
  and [8, 577, 3072]; every variant is held to the plain version.
- The f32 attention backward (csrc/attention_bwd.cu, dq_f32_kernel +
  dkdv_f32_kernel): builds with -DF32B_ROWS (query rows a dq block),
  -DF32B_KEYS (keys a dk/dv block), -DF32B_MIN_BLOCKS=1 and
  -DF32B_UNROLL=1 / 2, against the default build, at [101, 77, 2304] causal,
  [8, 257, 3072], [64, 257, 3072] (the f32 FT step's) and [8, 577, 3072];
  every variant is held to the plain version (dq, dk and dv apart) and to
  two bit-equal runs, beside the backward of torch's
  scaled_dot_product_attention and the bound.
- The event histogram (csrc/histogram.cu): clusters of 1 .. 16 CTAs in 1 to
  4 row bands at [320, 20000, 3] @ 180x240 and [256, 70000, 3] @ 480x640,
  each exact; the plan `histograms` launches is marked.

Prints the card's name and power limit first, then the registers and
spills of every kernel of every build as `nvcc -Xptxas -v` reports them.
Needs a CUDA card.
"""

from __future__ import annotations

import os
import re
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))

# f32 attention builds: source -> (the kernels the defines change, {name ->
# nvcc defines}); "default" is the library the wrappers load
VARIANTS = {
    "attention.cu": ("attention_f32_kernel", {
        "default": [], "min_blocks=1": ["-DF32_MIN_BLOCKS=1"],
        "unroll=1": ["-DF32_UNROLL=1"],
        **{f"rows={r}": [f"-DF32_ROWS={r}"]
           for r in (16, 32, 48, 64, 80, 96)}}),
    "attention_bwd.cu": ("_f32_kernel", {
        "default": [], "min_blocks=1": ["-DF32B_MIN_BLOCKS=1"],
        "unroll=1": ["-DF32B_UNROLL=1"], "unroll=2": ["-DF32B_UNROLL=2"],
        **{f"rows={r}": [f"-DF32B_ROWS={r}"] for r in (32, 48, 64, 80)},
        **{f"keys={r}": [f"-DF32B_KEYS={r}"] for r in (32, 48, 64, 80)}}),
}


def print_registers(label: str, log: str) -> None:
    """Each kernel of one build: registers a thread and bytes spilled."""
    name = stores = None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            # the mangled name holds each identifier after its length
            for m in re.finditer(r"\d+", line):
                ident = line[m.end():m.end() + int(m.group())]
                if ident.endswith("kernel") and ident.isidentifier():
                    name = ident
            dh = re.search(r"ILi(\d+)E", line)
            name = name and name + (f"<{dh.group(1)}>" if dh else
                                    "<int16>" if "IsE" in line else "<f32>")
        spill = re.search(r"(\d+) bytes spill stores", line)
        if spill and name:
            stores = spill.group(1)
        regs = re.search(r"Used (\d+) registers", line)
        if regs and name:
            print(f"  {label} {name}: {regs.group(1)} registers, {stores} "
                  "bytes spilled", flush=True)
            name = None


def build(kernels, tmp: str, sources):
    """Every source, and every variant of `sources`, at once with -Xptxas
    -v; returns {source: {variant: library path}} for `sources`."""
    jobs = {src: (os.path.join(tmp, f"{src}.so"), src, [])
            for src in kernels.SOURCES.values()}
    for src in sources:
        variants = VARIANTS[src][1]
        for name, defines in variants.items():
            if defines:
                jobs[f"{src} {name}"] = (
                    os.path.join(tmp, f"{src}-{name}.so"), src, defines)
    procs = {label: subprocess.Popen(
        [kernels.nvcc_path(), *kernels.NVCC_FLAGS, *defines, "-Xptxas", "-v",
         "-o", out, os.path.join(kernels.CSRC, src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for label, (out, src, defines) in jobs.items()}
    for label, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {label}:\n{log}")
        if label in kernels.SOURCES.values():
            print_registers(label, log)
        else:  # only the kernels the variant changes
            marker = VARIANTS[jobs[label][1]][0]
            print_registers(label, "\n".join(
                line for line in log.splitlines()
                if marker in line or "Used" in line or "spill" in line))
    return {src: {name: jobs[f"{src} {name}" if defines else src][0]
                  for name, defines in VARIANTS[src][1].items()}
            for src in sources}


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA device", file=sys.stderr)
        return 2
    parts = argv or ["forward", "backward", "histogram"]
    sys.path.insert(0, HERE)
    from chip_smoke import gpu_line
    from eventclip_tpu_torch import kernels

    print(gpu_line(), flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    sources = [src for part, src in (("forward", "attention.cu"),
                                     ("backward", "attention_bwd.cu"))
               if part in parts]
    with tempfile.TemporaryDirectory() as tmp:
        paths = build(kernels, tmp, sources)
        libs = {src: {name: kernels.load(path, kernels_name(kernels, src))
                      for name, path in builds.items()}
                for src, builds in paths.items()}
    if "forward" in parts:
        time_forward(libs["attention.cu"], gen, dev)
    if "backward" in parts:
        time_backward(libs["attention_bwd.cu"], gen, dev)
    if "histogram" in parts:
        time_histogram(gen, dev)
    return 0


def kernels_name(kernels, src):
    return next(n for n, f in kernels.SOURCES.items() if f == src)


def time_forward(libs, gen, dev):
    import torch
    import torch.nn.functional as F

    from chip_smoke import attention_bound, cuda_ms, hold
    from eventclip_tpu_torch import kernels
    from eventclip_tpu_torch.models.clip.model import causal_mask
    from eventclip_tpu_torch.ops import attention as A

    def forward(lib, qkv, heads, mask):
        B, S, D3 = qkv.shape
        D = D3 // 3
        dh = D // heads
        out = torch.empty((B, S, D), dtype=qkv.dtype, device=dev)
        rc = lib.attention_fwd(
            *A._column_blocks(qkv), None if mask is None else mask.data_ptr(),
            out.data_ptr(), B, S, heads, dh, S * D3, dh, D3, S * D, dh, D, 0,
            dh ** -0.5, torch.cuda.current_stream().cuda_stream)
        kernels.check(lib, rc, "attention_fwd")
        return out

    for B, S, heads, causal in ((101, 77, 12, True), (8, 257, 16, False),
                                (8, 577, 16, False)):
        D = heads * 64
        qkv = torch.randn((B, S, 3 * D), generator=gen, device=dev)
        mask = causal_mask(S, device=dev) if causal else None
        want = A.qkv_attention_plain(qkv, heads, mask)
        q, k, v = (t.reshape(B, S, heads, 64).transpose(1, 2).contiguous()
                   for t in qkv.split(D, -1))
        sdpa = cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal), iters=50)
        nbytes = B * S * 4 * D * 4 + (S * S * 4 if causal else 0)
        bound, by = attention_bound(nbytes, 4 * B * heads * S * S * 64,
                                    "float32")
        times = []
        for name, lib in libs.items():
            try:
                got = forward(lib, qkv, heads, mask)
            except RuntimeError:  # more rows than shared memory holds
                continue
            torch.cuda.synchronize()
            hold(name, [got], [want], "float32")
            ms = cuda_ms(lambda: forward(lib, qkv, heads, mask), iters=50)
            times.append(f"{name}: {ms:.4f}")
        print(f"K2 f32 [{B}, {S}, {3 * D}] causal={causal}: ms by build "
              f"{', '.join(times)}; sdpa {sdpa:.4f}; bound {bound:.4f} "
              f"({by})", flush=True)


def time_backward(libs, gen, dev):
    import torch
    import torch.nn.functional as F

    from chip_smoke import attention_bound, cuda_ms, hold
    from eventclip_tpu_torch import kernels
    from eventclip_tpu_torch.models.clip.model import causal_mask
    from eventclip_tpu_torch.ops import attention as A

    def backward(lib, qkv, g, heads, mask):
        B, S, D3 = qkv.shape
        D = D3 // 3
        dh = D // heads
        dqkv = torch.empty_like(qkv)
        stats = torch.empty(3 * B * heads * S, device=dev)
        rc = lib.attention_bwd(
            *A._column_blocks(qkv), g.data_ptr(),
            None if mask is None else mask.data_ptr(),
            *A._column_blocks(dqkv), stats.data_ptr(), B, S, heads, dh,
            S * D3, dh, D3, S * D, dh, D, 0, dh ** -0.5,
            torch.cuda.current_stream().cuda_stream)
        kernels.check(lib, rc, "attention_bwd")
        return dqkv

    for B, S, heads, causal in ((101, 77, 12, True), (8, 257, 16, False),
                                (64, 257, 16, False), (8, 577, 16, False)):
        D = heads * 64
        qkv = torch.randn((B, S, 3 * D), generator=gen, device=dev)
        g = torch.randn((B, S, D), generator=gen, device=dev)
        mask = causal_mask(S, device=dev) if causal else None
        want = A.qkv_attention_bwd_plain(qkv, g, heads, mask).split(D, -1)
        q, k, v = (t.reshape(B, S, heads, 64).transpose(1, 2).contiguous()
                   .requires_grad_() for t in qkv.split(D, -1))
        gh = g.reshape(B, S, heads, 64).transpose(1, 2).contiguous()
        out = F.scaled_dot_product_attention(q, k, v, is_causal=causal)
        sdpa = cuda_ms(lambda: torch.autograd.grad(
            out, (q, k, v), gh, retain_graph=True))
        del out
        nbytes = B * S * 7 * D * 4 + (S * S * 4 if causal else 0)
        bound, by = attention_bound(nbytes, 10 * B * heads * S * S * 64,
                                    "float32")
        times = []
        for name, lib in libs.items():
            try:
                got = backward(lib, qkv, g, heads, mask)
            except RuntimeError:  # more rows than shared memory holds
                continue
            torch.cuda.synchronize()
            if not torch.equal(got, backward(lib, qkv, g, heads, mask)):
                raise AssertionError(f"K3 f32 {name}: two runs differ")
            err, rel = hold(name, got.split(D, -1), want, "float32")
            ms = cuda_ms(lambda: backward(lib, qkv, g, heads, mask))
            times.append(f"{name}: {ms:.4f} (err {err:.3g}, rel "
                         f"{max(rel):.3g})")
        print(f"K3 f32 [{B}, {S}, {3 * D}] causal={causal}: ms by build "
              f"{', '.join(times)}; sdpa backward {sdpa:.4f}; bound "
              f"{bound:.4f} ({by})", flush=True)


def time_histogram(gen, dev):
    import torch

    from chip_smoke import HBM_BYTES_PER_S, cuda_ms, synth_windows
    from eventclip_tpu_torch.ops import rasterize as RZ

    limit = torch.cuda.get_device_properties(dev).shared_memory_per_block_optin
    for M, N, H, W in ((320, 20000, 180, 240), (256, 70000, 480, 640)):
        wins = synth_windows(gen, M, N, H, W, dev)
        want = RZ.histograms_plain(wins, H, W)
        chosen = RZ.device_histogram_plan(dev, H, W)
        bound = (wins.numel() * 2 + M * 2 * H * W * 4) / HBM_BYTES_PER_S * 1e3
        times = []
        for cluster in (1, 2, 4, 8, 16):
            for bands in (1, 2, 3, 4):
                rows = -(-2 * H // (cluster * bands))
                if (rows * W * 4 > limit
                        or (bands - 1) * cluster * rows >= 2 * H):
                    continue
                plan = RZ.HistogramPlan(cluster, rows, bands)

                def run():
                    return RZ.launch_histograms(wins, H, W, plan)

                if not torch.equal(run(), want):
                    raise AssertionError(f"histogram {plan}: not exact")
                ms = cuda_ms(run, iters=50)
                mark = " (plan)" if plan == chosen else ""
                times.append(f"{cluster}x{bands}{mark}: {ms:.4f}")
        print(f"K1 [{M}, {N}, 3] @ {H}x{W}: ms by CTAs a cluster x bands "
              f"{', '.join(times)}; bound {bound:.4f} (bytes)", flush=True)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
