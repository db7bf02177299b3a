"""k2_roofline.batch: K2 (csrc/attention.cu, `eventclip::qkv_attention`)
in the serving window, its bound over its device time. Each launch reads
the fused [K, S, 3D] bf16 q/k/v and writes the [K, S, D] output (bytes),
and does 4 K H S^2 dh operations (q k^T and p v); K is the request's
packed view count. Kernels are matched by name in the trace."""

from portbench.peaks import bound_s

KERNELS = ("attention_wgmma_kernel", "attention_f32_kernel")


def k2_bound_s(views: int, v, dtype: str = "bfloat16") -> float:
    d, h = v["width"], v["heads"]
    S = (v["image_size"] // v["patch_size"]) ** 2 + 1
    item = 2 if dtype == "bfloat16" else 4
    nbytes = views * S * 4 * d * item
    flops = 4.0 * views * S * S * d
    return bound_s(nbytes, flops, dtype)


def read(ctx):
    if ctx.trace is None or not ctx.requests:
        return None
    ks = ctx.trace.matching(KERNELS)
    if not ks:
        return None
    v = ctx.config["vision"]
    per_launch = sum(k2_bound_s(r["bucket"], v) for r in ctx.requests) \
        / len(ctx.requests)
    return 100.0 * per_launch * len(ks) / sum(d for _, _, d in ks)
