"""dense_roofline.batch: D1 (csrc/dense.cu, `eventclip::dense_bf16`, the
bf16 products of the ViT tower) in the serving window, its bound over its
device time. A request runs 4 products a block on D1 (q/k/v, out, MLP in,
MLP out; the patch embedding keeps the library GEMM) over M = bucket x S
tokens: each reads x [M, K], w [N, K] and the f32 bias and writes the
bf16 [M, N] once (bytes), and does 2 M K N operations. A launch's bound is
its request's over the request's 4 L launches, counted for every launch
the trace holds, so a launch the trace drops cannot raise the share.
Kernels are matched by name in the trace."""

from portbench.peaks import bound_s

KERNELS = ("dense_wgmma_kernel",)


def block_products(v):
    """(K, N) of one block's products on D1."""
    d, m = v["width"], v["mlp_width"]
    return [(d, 3 * d), (d, d), (d, m), (m, d)]


def request_bound_s(views: int, v) -> float:
    """The least time of a request's D1 products: each product's larger of
    bytes over the memory bandwidth and operations over the bf16 peak."""
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
