"""dense_roofline.eva: D1 (csrc/dense.cu, `eventclip::dense_bf16`) in the
EVA02 serving window, its bound over its device time. A block runs 4
products on D1 at the shapes D1 computes: q/k/v (K, N) = (D, 3D), out
(D, D), W1 and W2 fused (D, 2 Hs) and W3 (Hs, D), with Hs the hidden
width as stored (`mlp_hidden` rounded up to a multiple of 8: 2736), over
M = bucket x S tokens; the patch embedding (K = 588) keeps the library
GEMM. Each product's bound is `dense_roofline.batch`'s (the larger of its
bytes over the bandwidth and 2 M K N over the bf16 peak), a launch's the
request's over its 4 L launches, counted for every launch the trace
holds."""

from portbench.peaks import bound_s

KERNELS = ("dense_wgmma_kernel",)


def block_products(v):
    """(K, N) of one EVA02 block's products on D1."""
    d, hs = v["width"], -(-v["mlp_hidden"] // 8) * 8
    return [(d, 3 * d), (d, d), (d, 2 * hs), (hs, d)]


def request_bound_s(views: int, v) -> float:
    S = (v["image_size"] // v["patch_size"]) ** 2 + 1
    M = views * S
    return v["layers"] * sum(
        bound_s(2 * (M * k + n * k + M * n) + 4 * n, 2.0 * M * k * n,
                "bfloat16")
        for k, n in block_products(v))


def read(ctx):
    if ctx.trace is None or not ctx.requests:
        return None
    ks = ctx.trace.matching(KERNELS)
    if not ks:
        return None
    v = ctx.config["vision"]
    launches = len(block_products(v)) * v["layers"]
    per_launch = sum(request_bound_s(r["bucket"], v) / launches
                     for r in ctx.requests) / len(ctx.requests)
    return 100.0 * per_launch * len(ks) / sum(d for _, _, d in ks)
