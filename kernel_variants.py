#!/usr/bin/env python3
"""Time the shape choices of two CUDA kernels on one card.

    python3 kernel_variants.py

- The f32 attention forward (csrc/attention.cu, attention_f32_kernel):
  builds of the source with -DF32_ROWS (query rows a block, 16 .. 96),
  -DF32_MIN_BLOCKS=1 (one block an SM, so more registers a thread) and
  -DF32_UNROLL=1 (the inner loops not unrolled), against the default
  build, at the text tower's [101, 77, 2304] causal shape, [8, 257, 3072]
  and [8, 577, 3072]; every variant is held to the plain version.
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

# f32 attention builds: name -> nvcc defines ("default" is the library the
# wrappers load)
F32_VARIANTS = {"default": [], "min_blocks=1": ["-DF32_MIN_BLOCKS=1"],
                "unroll=1": ["-DF32_UNROLL=1"],
                **{f"rows={r}": [f"-DF32_ROWS={r}"]
                   for r in (16, 32, 48, 64, 80, 96)}}


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


def build(kernels, tmp: str):
    """Every source, and every f32 attention variant, at once with
    -Xptxas -v; returns {variant: library path}."""
    jobs = {src: (os.path.join(tmp, f"{src}.so"), src, [])
            for src in kernels.SOURCES.values()}
    for name, defines in F32_VARIANTS.items():
        if defines:
            jobs[f"attention.cu {name}"] = (os.path.join(tmp, f"{name}.so"),
                                            "attention.cu", defines)
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
        else:  # only the kernel the variant changes
            print_registers(label, "\n".join(
                line for line in log.splitlines()
                if "attention_f32_kernel" in line or "Used" in line
                or "spill" in line))
    return {name: jobs[f"attention.cu {name}" if defines else
                       "attention.cu"][0]
            for name, defines in F32_VARIANTS.items()}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import torch.nn.functional as F

    from chip_smoke import (HBM_BYTES_PER_S, attention_bound, cuda_ms,
                            gpu_line, hold, synth_windows)
    from eventclip_tpu_torch import kernels
    from eventclip_tpu_torch.models.clip.model import causal_mask
    from eventclip_tpu_torch.ops import attention as A
    from eventclip_tpu_torch.ops import rasterize as RZ

    print(gpu_line(), flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    with tempfile.TemporaryDirectory() as tmp:
        libs = {name: kernels.load(path, "attention")
                for name, path in build(kernels, tmp).items()}

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
    return 0


if __name__ == "__main__":
    sys.exit(main())
