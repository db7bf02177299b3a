"""mfu.batch: the serving step's share of the card's bf16 peak, the useful
operations of the window (every valid view through the ViT tower, 162.0
GFLOP a view at ViT-L/14) over the traced window's wall time. Padding
views that packing encodes are not useful work and are not counted."""

from portbench.peaks import FLOPS_PER_S


def vit_forward_flops(v) -> float:
    """Operations of one image through a ViT tower: the patch embedding,
    per block the q/k/v, output and MLP products (4 d^2 + 2 d m a token)
    and attention's two S x S products (2 S^2 d), the projection; every
    multiply-add counted as 2."""
    d, m, L = v["width"], v["mlp_width"], v["layers"]
    g = v["image_size"] // v["patch_size"]
    S = g * g + 1
    macs = g * g * 3 * v["patch_size"] ** 2 * d
    macs += L * (S * (4 * d * d + 2 * d * m) + 2 * S * S * d)
    macs += d * v["output_dim"]
    return 2.0 * macs


def read(ctx):
    views = sum(r["valid_views"] for r in ctx.requests)
    if not views or ctx.window_s <= 0:
        return None
    flops = views * vit_forward_flops(ctx.config["vision"])
    return 100.0 * flops / (ctx.window_s * FLOPS_PER_S["bfloat16"])
