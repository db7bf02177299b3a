"""k2_roofline.train: K2 (csrc/attention.cu, `eventclip::qkv_attention`)
in the training window, its bound over its device time: each launch at
[views, S, 3D] bf16 (256 views of ViT-L/14: [256, 257, 3072]), 2 L
launches a step (the forward and the remat recompute), its bound
`k2_roofline.batch`'s arithmetic."""

import os

from portbench import core

HERE = os.path.dirname(os.path.abspath(__file__))
KERNELS = ("attention_wgmma_kernel", "attention_f32_kernel")


def read(ctx):
    if ctx.trace is None or not getattr(ctx, "steps", None):
        return None
    ks = ctx.trace.matching(KERNELS)
    if not ks:
        return None
    k2 = core.load_file(os.path.join(HERE, "k2_roofline.batch.py"),
                        "metric_k2_roofline.batch")
    g = ctx.geometry
    bound = k2.k2_bound_s(g["batch"] * g["views"], ctx.config["vision"])
    return 100.0 * bound * len(ks) / sum(d for _, _, d in ks)
