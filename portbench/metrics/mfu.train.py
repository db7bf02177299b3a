"""mfu.train: the training window's share of the card's bf16 peak: the
useful operations of every step (each of the step's views through the
ViT tower forward and backward, 3 x 162.0 GFLOP a view at ViT-L/14; the
remat recompute is not useful work) over the window's wall time."""

import os

from portbench import core
from portbench.peaks import FLOPS_PER_S

HERE = os.path.dirname(os.path.abspath(__file__))


def step_flops(v, views: int) -> float:
    """A step's useful operations: forward and backward (twice the
    forward's) of every view."""
    fwd = core.load_file(os.path.join(HERE, "mfu.batch.py"),
                         "metric_mfu.batch").vit_forward_flops(v)
    return 3.0 * views * fwd


def read(ctx):
    steps = getattr(ctx, "steps", None)
    if not steps or ctx.window_s <= 0:
        return None
    g = ctx.geometry
    flops = len(steps) * step_flops(ctx.config["vision"],
                                    g["batch"] * g["views"])
    return 100.0 * flops / (ctx.window_s * FLOPS_PER_S["bfloat16"])
