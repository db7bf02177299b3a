"""k3_roofline.train: K3 (csrc/attention_bwd.cu,
`eventclip::qkv_attention_bwd`, the pair `dq_wgmma_kernel` +
`dkdv_wgmma_kernel`) in the training window, its bound over the pair's
device time. A launch reads the fused [K, S, 3D] bf16 q/k/v and the
[K, S, D] output gradient and writes the [K, S, 3D] q/k/v gradient
(bytes; the row statistics it keeps between the pair are its own
scratch), and needs the TPU kernel's 5 products, 10 K H S^2 dh
operations (s, dp, dv, dq, dk); K is the step's view count, one launch a
layer a step. A launch is one dq kernel of the trace."""

from portbench.peaks import bound_s

PAIR = ("dq_wgmma_kernel", "dkdv_wgmma_kernel")


def k3_bound_s(views: int, v) -> float:
    d = v["width"]
    S = (v["image_size"] // v["patch_size"]) ** 2 + 1
    nbytes = views * S * 7 * d * 2
    flops = 10.0 * views * S * S * d
    return bound_s(nbytes, flops, "bfloat16")


def read(ctx):
    if ctx.trace is None or not getattr(ctx, "steps", None):
        return None
    dq = ctx.trace.matching(PAIR[:1])
    pair = ctx.trace.matching(PAIR)
    if not dq:
        return None
    g = ctx.geometry
    bound = k3_bound_s(g["batch"] * g["views"], ctx.config["vision"])
    return 100.0 * bound * len(dq) / sum(d for _, _, d in pair)
