#!/usr/bin/env python3
"""Time the shape choices of the CUDA kernels on one card.

    python3 kernel_variants.py [forward] [backward] [wgmma] [histogram]
                               [dense] [swiglu]
    python3 kernel_variants.py compare DIR

(no argument: the first four)

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
- The bf16 wgmma kernels (attention_wgmma_kernel; dq_wgmma_kernel +
  dkdv_wgmma_kernel): builds with -DWGF_CONSUMERS / -DWGB_CONSUMERS
  (consumer warpgroups a block), -DWGF_ROWS=128 (query rows a warpgroup
  takes at once: two m64 products a step) and -DWGF_STAGES / -DWGB_STAGES
  (a cap on the ring's slots: below a head's chunks its K and V, or Q and
  G, stream through that many slots instead of staying resident), against
  the default build, the forward at the serving [320, 257, 3072] and FT
  [256, 257, 3072] shapes, the backward at the FT shape and [64, 257,
  3072]; each held to the plain version (the backward also to two
  bit-equal runs), beside torch's scaled_dot_product_attention (its
  backward for K3) and the bound.
- The event histogram (csrc/histogram.cu): clusters of 1 .. 16 CTAs in 1 to
  4 row bands at [320, 20000, 3] @ 180x240 and [256, 70000, 3] @ 480x640,
  each exact; the plan `histograms` launches is marked.
- D1, the bf16 dense product (csrc/dense.cu, dense_wgmma_kernel):
  builds with -DD1_STAGES_256 / -DD1_STAGES_128 (the ring's stages at
  each tile width) against the default build, each under both tile
  widths (128 x 256 and 128 x 128, one persistent block an SM), at every
  path's products (chip_smoke.DENSE_PATHS: serving, FT, the FS step's
  frozen tower, and the bf16 shapes of the text tower and the FS adapter,
  which run in f32 on the paths); each held bit-equal to the default
  build under the plan `dense_plan` picks (only the order of the f32 sums
  could differ, and it does not), beside the route D1 replaced
  (`addmm(out_dtype=f32)` and the cast), a plain bf16 `torch.mm` with no
  bias and the bound. The plan the wrapper picks is marked.
- S1, EVA02's SwiGLU glue (csrc/swiglu.cu, swiglu_ln_kernel): builds with
  -DS1_UNROLL (16-byte vectors of each half a lane has in flight: 2 by
  default; 1, 4) and -DS1_MIN_BLOCKS (the resident blocks an SM the
  registers are cut to: 4 by default; 3, 5) at the EVA02 request's [320,
  577, 5472] and a ragged [3, 37, 5472]; each held to the plain version
  within one bf16 ulp, beside the plain version's time and the bound.
- compare DIR: the bf16 K2 and K3 of this checkout against those of the
  checkout at DIR (another commit of this repository, its kernels built
  there), through the public wrappers `fused_qkv_attention` and
  `qkv_attention_bwd`, at every bf16 shape the port's paths give them
  (SHAPES), each held to its plain version; four processes in turn (DIR,
  this, this, DIR), so both are timed on one card in one call. Every time
  is the host's view of 20 launches back to back (CUDA events), which at
  the small shapes is the launch's host cost: the device time of each
  launch (torch.profiler) is printed beside it.

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

# builds: (part, source) -> (the kernels the defines change, {name -> nvcc
# defines}); "default" is the library the wrappers load
VARIANTS = {
    ("forward", "attention.cu"): ("attention_f32_kernel", {
        "default": [], "min_blocks=1": ["-DF32_MIN_BLOCKS=1"],
        "unroll=1": ["-DF32_UNROLL=1"],
        **{f"rows={r}": [f"-DF32_ROWS={r}"]
           for r in (16, 32, 48, 64, 80, 96)}}),
    ("backward", "attention_bwd.cu"): ("_f32_kernel", {
        "default": [], "min_blocks=1": ["-DF32B_MIN_BLOCKS=1"],
        "unroll=1": ["-DF32B_UNROLL=1"], "unroll=2": ["-DF32B_UNROLL=2"],
        **{f"rows={r}": [f"-DF32B_ROWS={r}"] for r in (32, 48, 64, 80)},
        **{f"keys={r}": [f"-DF32B_KEYS={r}"] for r in (32, 48, 64, 80)}}),
    ("wgmma", "attention.cu"): ("attention_wgmma_kernel", {
        "default": [],
        **{f"consumers={c}": [f"-DWGF_CONSUMERS={c}"] for c in (1, 3, 4)},
        "rows=128": ["-DWGF_ROWS=128"],
        **{f"stages={n}": [f"-DWGF_STAGES={n}"] for n in (2, 3)}}),
    ("wgmma", "attention_bwd.cu"): ("_wgmma_kernel", {
        "default": [],
        **{f"consumers={c}": [f"-DWGB_CONSUMERS={c}"] for c in (2, 3)},
        **{f"stages={n}": [f"-DWGB_STAGES={n}"] for n in (2, 3)}}),
    ("dense", "dense.cu"): ("dense_wgmma_kernel", {
        "default": [], "stages256=3": ["-DD1_STAGES_256=3"],
        "stages128=4": ["-DD1_STAGES_128=4"]}),
    ("swiglu", "swiglu.cu"): ("swiglu_ln_kernel", {
        "default": [],
        **{f"unroll={n}": [f"-DS1_UNROLL={n}"] for n in (1, 4)},
        **{f"min_blocks={n}": [f"-DS1_MIN_BLOCKS={n}"] for n in (3, 5)}}),
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
            masked = re.search(r"ILi\d+ELb([01])E", line)
            name = name and name + (f"<{dh.group(1)}>" if dh else
                                    "<int16>" if "IsE" in line else "<f32>")
            if name and masked and masked.group(1) == "1":
                name += " bias" if name.startswith("dense") else " masked"
        spill = re.search(r"(\d+) bytes spill stores", line)
        if spill and name:
            stores = spill.group(1)
        regs = re.search(r"Used (\d+) registers", line)
        if regs and name:
            print(f"  {label} {name}: {regs.group(1)} registers, {stores} "
                  "bytes spilled", flush=True)
            name = None


def build(kernels, tmp: str, families):
    """Every source, and every variant of the `families` ((part, source)
    keys of VARIANTS), at once with -Xptxas -v; returns {family: {variant:
    library path}}."""
    jobs = {src: (os.path.join(tmp, f"{src}.so"), src, [], None)
            for src in kernels.SOURCES.values()}
    for fam in families:
        src = fam[1]
        for name, defines in VARIANTS[fam][1].items():
            if defines:
                jobs[f"{src} {name}"] = (
                    os.path.join(tmp, f"{src}-{name}.so"), src, defines, fam)
    procs = {label: subprocess.Popen(
        [kernels.nvcc_path(), *kernels.NVCC_FLAGS, *defines, "-Xptxas", "-v",
         "-o", out, os.path.join(kernels.CSRC, src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for label, (out, src, defines, _) in jobs.items()}
    for label, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {label}:\n{log}")
        fam = jobs[label][3]
        if fam is None:
            print_registers(label, log)
        else:  # only the kernels the variant changes
            marker = VARIANTS[fam][0]
            print_registers(label, "\n".join(
                line for line in log.splitlines()
                if marker in line or "Used" in line or "spill" in line))
    return {fam: {name: jobs[f"{fam[1]} {name}" if defines else fam[1]][0]
                  for name, defines in VARIANTS[fam][1].items()}
            for fam in families}


# bf16 K2 / K3 shapes of the port's paths: (path, B, S, heads, width D)
SHAPES = [
    ("serve", 320, 257, 16, 1024), ("eval / teacher", 640, 257, 16, 1024),
    ("FT", 256, 257, 16, 1024), ("FS / ddp FT", 64, 257, 16, 1024),
    ("split part", 160, 257, 16, 1024), ("pruned", 320, 129, 16, 1024),
    ("TP rank", 16, 257, 8, 512), ("ZeRO-1 rank", 8, 257, 16, 1024),
    ("ViT-L/14@336", 32, 577, 16, 1024), ("text bf16", 101, 77, 12, 768),
]
BACKWARD = {"FT", "FS / ddp FT", "TP rank", "ZeRO-1 rank", "ViT-L/14@336",
            "text bf16"}


def time_shapes(root: str) -> dict:
    """K2 (and K3 where a path trains) at SHAPES through the public wrappers
    of the package under `root`: {path: {fwd, fwd_device_us, bwd,
    bwd_device_us}} in ms / us."""
    import torch

    sys.path.insert(0, root)
    from chip_smoke import ATOL, REL, cuda_ms, hold
    from eventclip_tpu_torch.models.clip.model import causal_mask
    from eventclip_tpu_torch.ops import attention as A

    def device_us(fn):
        prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA])
        with prof:
            for _ in range(5):
                fn()
            torch.cuda.synchronize()
        return sum(e.device_time_total for e in prof.key_averages()
                   if "attention" in e.key or "dq_" in e.key
                   or "dkdv" in e.key) / 5

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {}
    for path, B, S, heads, D in SHAPES:
        qkv = torch.randn((B, S, 3 * D), generator=gen, device=dev).bfloat16()
        mask = causal_mask(S, device=dev) if path == "text bf16" else None
        hold(path, [A.fused_qkv_attention(qkv, heads, mask)],
             [A.qkv_attention_plain(qkv, heads, mask)], "bfloat16")
        row = out[path] = dict(
            fwd=cuda_ms(lambda: A.fused_qkv_attention(qkv, heads, mask)),
            fwd_device_us=device_us(
                lambda: A.fused_qkv_attention(qkv, heads, mask)))
        if path in BACKWARD:
            g = torch.randn((B, S, D), generator=gen, device=dev).bfloat16()
            hold(path, A.qkv_attention_bwd(qkv, g, heads, mask).split(D, -1),
                 A.qkv_attention_bwd_plain(qkv, g, heads, mask).split(D, -1),
                 "bfloat16")
            row.update(
                bwd=cuda_ms(lambda: A.qkv_attention_bwd(qkv, g, heads, mask)),
                bwd_device_us=device_us(
                    lambda: A.qkv_attention_bwd(qkv, g, heads, mask)))
        del qkv
        torch.cuda.empty_cache()
    return out


def compare(other: str) -> None:
    """The bf16 attention kernels of `other` and of this checkout, timed in
    four processes in turn (other, this, this, other)."""
    import json

    runs = []
    for root in (other, HERE, HERE, other):
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--shapes", root],
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"timing {root} failed:\n{proc.stdout}\n"
                               f"{proc.stderr}")
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
    for path, *_ in SHAPES:
        for key, unit in (("fwd", "K2"), ("bwd", "K3")):
            if key not in runs[0][path]:
                continue
            cells = [f"{r[path][key]:.4f} ms ({r[path][key + '_device_us']:.1f}"
                     " us on the device)" for r in runs]
            print(f"{unit} {path}: other {cells[0]}, this {cells[1]}, this "
                  f"{cells[2]}, other {cells[3]}", flush=True)


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA device", file=sys.stderr)
        return 2
    if argv[:1] == ["--shapes"]:  # one process of `compare`
        import json

        print(json.dumps(time_shapes(os.path.abspath(argv[1]))), flush=True)
        return 0
    sys.path.insert(0, HERE)
    if argv[:1] == ["compare"]:
        from chip_smoke import gpu_line

        print(gpu_line(), flush=True)
        compare(os.path.abspath(argv[1]))
        return 0
    parts = argv or ["forward", "backward", "wgmma", "histogram"]
    from chip_smoke import gpu_line
    from eventclip_tpu_torch import kernels

    print(gpu_line(), flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    families = [fam for fam in VARIANTS if fam[0] in parts]
    with tempfile.TemporaryDirectory() as tmp:
        paths = build(kernels, tmp, families)
        libs = {fam: {name: kernels.load(path, kernels_name(kernels, fam[1]))
                      for name, path in builds.items()}
                for fam, builds in paths.items()}
    if "forward" in parts:
        time_forward(libs["forward", "attention.cu"], gen, dev)
    if "backward" in parts:
        time_backward(libs["backward", "attention_bwd.cu"], gen, dev)
    if "wgmma" in parts:
        time_wgmma(libs["wgmma", "attention.cu"],
                   libs["wgmma", "attention_bwd.cu"], gen, dev)
    if "histogram" in parts:
        time_histogram(gen, dev)
    if "dense" in parts:
        time_dense(libs["dense", "dense.cu"], gen, dev)
    if "swiglu" in parts:
        time_swiglu(libs["swiglu", "swiglu.cu"], gen, dev)
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
            dh ** -0.5, torch.cuda.current_stream().cuda_stream, None, None)
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
            torch.cuda.current_stream().cuda_stream, None, None, None)
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


def time_wgmma(fwd_libs, bwd_libs, gen, dev):
    import torch
    import torch.nn.functional as F

    from chip_smoke import attention_bound, cuda_ms, hold
    from eventclip_tpu_torch import kernels
    from eventclip_tpu_torch.ops import attention as A

    def maps(B, S, heads, dh, D):
        return (A.tma_map(B, S, heads, dh, (S * 3 * D, dh, 3 * D)),
                A.tma_map(B, S, heads, dh, (S * D, dh, D)))

    def forward(lib, qkv, heads):
        B, S, D3 = qkv.shape
        D = D3 // 3
        dh = D // heads
        out = torch.empty((B, S, D), dtype=qkv.dtype, device=dev)
        rc = lib.attention_fwd(
            *A._column_blocks(qkv), None, out.data_ptr(), B, S, heads, dh,
            S * D3, dh, D3, S * D, dh, D, 1, dh ** -0.5,
            torch.cuda.current_stream().cuda_stream,
            *(m.as_ctypes() for m in maps(B, S, heads, dh, D)))
        kernels.check(lib, rc, "attention_fwd")
        return out

    def backward(lib, qkv, g, heads):
        B, S, D3 = qkv.shape
        D = D3 // 3
        dh = D // heads
        dqkv = torch.empty_like(qkv)
        stats = torch.empty(3 * B * heads * A.stats_rows(S), device=dev)
        in_map, g_map = maps(B, S, heads, dh, D)
        rc = lib.attention_bwd(
            *A._column_blocks(qkv), g.data_ptr(), None,
            *A._column_blocks(dqkv), stats.data_ptr(), B, S, heads, dh,
            S * D3, dh, D3, S * D, dh, D, 1, dh ** -0.5,
            torch.cuda.current_stream().cuda_stream, in_map.as_ctypes(),
            g_map.as_ctypes(), A.stats_map(B * heads, S).as_ctypes())
        kernels.check(lib, rc, "attention_bwd")
        return dqkv

    for B, S in ((320, 257), (256, 257)):
        qkv = torch.randn((B, S, 3072), generator=gen, device=dev).bfloat16()
        want = A.qkv_attention_plain(qkv, 16)
        q, k, v = (t.reshape(B, S, 16, 64).transpose(1, 2).contiguous()
                   for t in qkv.split(1024, -1))
        sdpa = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v),
                       iters=50)
        bound, by = attention_bound(B * S * 4096 * 2,
                                    4 * B * 16 * S * S * 64, "bfloat16")
        times = []
        for name, lib in fwd_libs.items():
            got = forward(lib, qkv, 16)
            torch.cuda.synchronize()
            err, rel = hold(name, [got], [want], "bfloat16")
            ms = cuda_ms(lambda: forward(lib, qkv, 16), iters=50)
            times.append(f"{name}: {ms:.4f} (err {err:.3g}, rel {max(rel):.3g})")
        print(f"K2 bf16 [{B}, {S}, 3072]: ms by build {', '.join(times)}; "
              f"sdpa {sdpa:.4f}; bound {bound:.4f} ({by})", flush=True)
    for B, S in ((256, 257), (64, 257)):
        qkv = torch.randn((B, S, 3072), generator=gen, device=dev).bfloat16()
        g = torch.randn((B, S, 1024), generator=gen, device=dev).bfloat16()
        want = A.qkv_attention_bwd_plain(qkv, g, 16).split(1024, -1)
        q, k, v = (t.reshape(B, S, 16, 64).transpose(1, 2).contiguous()
                   .requires_grad_() for t in qkv.split(1024, -1))
        gh = g.reshape(B, S, 16, 64).transpose(1, 2).contiguous()
        out = F.scaled_dot_product_attention(q, k, v)
        sdpa = cuda_ms(lambda: torch.autograd.grad(
            out, (q, k, v), gh, retain_graph=True))
        del out
        bound, by = attention_bound(B * S * 7 * 1024 * 2,
                                    10 * B * 16 * S * S * 64, "bfloat16")
        times = []
        for name, lib in bwd_libs.items():
            got = backward(lib, qkv, g, 16)
            torch.cuda.synchronize()
            if not torch.equal(got, backward(lib, qkv, g, 16)):
                raise AssertionError(f"K3 bf16 {name}: two runs differ")
            err, rel = hold(name, got.split(1024, -1), want, "bfloat16")
            ms = cuda_ms(lambda: backward(lib, qkv, g, 16))
            times.append(f"{name}: {ms:.4f} (err {err:.3g}, rel "
                         f"{max(rel):.3g})")
        print(f"K3 bf16 [{B}, {S}, 3072] + g: ms by build "
              f"{', '.join(times)}; sdpa backward {sdpa:.4f}; bound "
              f"{bound:.4f} ({by})", flush=True)


def time_dense(libs, gen, dev):
    import torch

    from chip_smoke import DENSE_PATHS, cuda_ms, dense_bound
    from eventclip_tpu_torch import kernels
    from eventclip_tpu_torch.ops import dense as DN

    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def run(lib, x, w, b, width):
        M, K = x.shape
        N = w.shape[0]
        blocks = min(-(-M // DN.TILE_ROWS) * -(-N // width), sms)
        out = torch.empty((M, N), dtype=x.dtype, device=dev)
        rc = lib.dense_bf16(x.data_ptr(), w.data_ptr(), b.data_ptr(),
                            out.data_ptr(), M, N, K, width, blocks,
                            torch.cuda.current_stream().cuda_stream)
        kernels.check(lib, rc, "dense_bf16")
        return out

    for path, (M, products) in DENSE_PATHS.items():
        for K, N in products:
            x = torch.randn((M, K), generator=gen, device=dev).bfloat16()
            w = (torch.randn((N, K), generator=gen, device=dev) / K ** 0.5
                 ).bfloat16()
            b = torch.randn((N,), generator=gen, device=dev)
            picked = DN.dense_plan(M, N, sms)[0]
            want = run(libs["default"], x, w, b, picked)
            times = []
            for name, lib in libs.items():
                for width in DN.TILE_WIDTHS:
                    if not torch.equal(run(lib, x, w, b, picked), want):
                        raise AssertionError(f"D1 {name} differs")
                    ms = cuda_ms(lambda: run(lib, x, w, b, width), iters=50)
                    mark = "*" if name == "default" and width == picked \
                        else ""
                    times.append(f"{name} x{width}{mark}: {ms:.4f}")
            library = cuda_ms(lambda: DN.library_dense(x, w, b), iters=50)
            mm = cuda_ms(lambda: torch.mm(x, w.t()), iters=50)
            bound, by = dense_bound(M, K, N)
            print(f"D1 {path} [{M}, {K}] x [{N}, {K}]: ms by build and "
                  f"tile width {', '.join(times)}; addmm + cast {library:.4f};"
                  f" bf16 mm {mm:.4f}; bound {bound:.4f} ({by})", flush=True)


def time_swiglu(libs, gen, dev):
    import torch

    from chip_smoke import cuda_ms, swiglu_bound
    from eventclip_tpu_torch import kernels
    from eventclip_tpu_torch.ops.swiglu import swiglu_plain

    def run(lib, h12, w, b):
        Hs = h12.shape[-1] // 2
        out = h12.new_empty((*h12.shape[:-1], Hs))
        rc = lib.swiglu_ln(h12.data_ptr(), w.data_ptr(), b.data_ptr(),
                           out.data_ptr(), h12.numel() // (2 * Hs),
                           w.shape[0], Hs, 1e-6,
                           torch.cuda.current_stream().cuda_stream)
        kernels.check(lib, rc, "swiglu_ln")
        return out

    # (views, tokens, H, Hs): the EVA02 request's, a ragged one
    for B, S, H, Hs in ((320, 577, 2730, 2736), (3, 37, 2730, 2736)):
        h12 = (2 * torch.randn((B, S, 2 * Hs), generator=gen, device=dev)
               ).bfloat16()
        w = 1 + 0.2 * torch.randn((H,), generator=gen, device=dev)
        b = 0.1 * torch.randn((H,), generator=gen, device=dev)
        want = swiglu_plain(h12, w, b, 1e-6)
        times = []
        for name, lib in libs.items():
            got = run(lib, h12, w, b)
            torch.testing.assert_close(got.float(), want.float(),
                                       rtol=2 ** -7, atol=1e-3)
            if got[..., H:].any():
                raise AssertionError(f"S1 {name}: a pad column not 0")
            ms = cuda_ms(lambda: run(lib, h12, w, b), iters=50)
            times.append(f"{name}: {ms:.4f}")
        plain = cuda_ms(lambda: swiglu_plain(h12, w, b, 1e-6), iters=5)
        bound, by = swiglu_bound(B * S, Hs)
        print(f"S1 [{B}, {S}, {2 * Hs}] H {H}: ms by build "
              f"{', '.join(times)}; plain {plain:.4f}; bound {bound:.4f} "
              f"({by})", flush=True)
        del h12, want
        torch.cuda.empty_cache()


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
