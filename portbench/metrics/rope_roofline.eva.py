"""rope_roofline.eva: the rotary kernel (csrc/rope.cu, `eventclip::rope_qkv`)
in the EVA02 serving window, its bound over its device time. Each launch
reads and writes the bf16 q and k of tokens 1 ... S-1 of the fused
[K, S, 3D] q/k/v in place, 2 x 2 x K (S-1) 2D bytes, over the memory
bandwidth (the f32 tables it reads, 2 (S-1) dh 4 bytes from L2, are left
out); K is the request's packed view count. Kernels are matched by name
in the trace."""

from portbench.peaks import HBM_BYTES_PER_S

KERNELS = ("rope_qkv_kernel",)


def rope_bound_s(views: int, v) -> float:
    S = (v["image_size"] // v["patch_size"]) ** 2 + 1
    return 2 * 2 * views * (S - 1) * 2 * v["width"] / HBM_BYTES_PER_S


def read(ctx):
    if ctx.trace is None or not ctx.requests:
        return None
    ks = ctx.trace.matching(KERNELS)
    if not ks:
        return None
    v = ctx.config["vision"]
    per_launch = sum(rope_bound_s(r["bucket"], v) for r in ctx.requests) \
        / len(ctx.requests)
    return 100.0 * per_launch * len(ks) / sum(d for _, _, d in ks)
