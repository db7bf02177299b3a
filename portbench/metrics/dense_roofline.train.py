"""dense_roofline.train: D1 (csrc/dense.cu, `eventclip::dense_bf16`) in the
training window, its bound over its device time. A step runs the tower's
4 products a block on D1 twice (the forward and the remat recompute; the
backward's products are library GEMMs) over M = views x S tokens (M =
65,792 at 256 views of ViT-L/14). A launch's bound is
`dense_roofline.batch`'s arithmetic for that M over its 4 L products,
counted for every launch the trace holds."""

import os

from portbench import core

HERE = os.path.dirname(os.path.abspath(__file__))
KERNELS = ("dense_wgmma_kernel",)


def launch_bound_s(views: int, v) -> float:
    batch = core.load_file(os.path.join(HERE, "dense_roofline.batch.py"),
                           "metric_dense_roofline.batch")
    return batch.request_bound_s(views, v) / (
        len(batch.block_products(v)) * v["layers"])


def read(ctx):
    if ctx.trace is None or not getattr(ctx, "steps", None):
        return None
    ks = ctx.trace.matching(KERNELS)
    if not ks:
        return None
    g = ctx.geometry
    bound = launch_bound_s(g["batch"] * g["views"], ctx.config["vision"])
    return 100.0 * bound * len(ks) / sum(d for _, _, d in ks)
