"""mfu.eva: the EVA02 serving step's share of the card's bf16 peak, the
useful operations of the window (every valid view through the tower at
its published widths, the hidden 2730 unpadded: 381.9 GFLOP a view at
EVA02-L/14-336) over the traced window's wall time. Padding views, the
stored hidden's pad and the rotary positions are not counted."""

from portbench.peaks import FLOPS_PER_S


def eva_forward_flops(v) -> float:
    """Operations of one image through an EVA02 tower: the patch
    embedding, per block the q/k/v and out products (4 d^2 a token), the
    SwiGLU's three (3 d h a token) and attention's two S x S products
    (2 S^2 d), the head; every multiply-add counted as 2."""
    d, h, L = v["width"], v["mlp_hidden"], v["layers"]
    g = v["image_size"] // v["patch_size"]
    S = g * g + 1
    macs = g * g * 3 * v["patch_size"] ** 2 * d
    macs += L * (S * (4 * d * d + 3 * d * h) + 2 * S * S * d)
    macs += d * v["output_dim"]
    return 2.0 * macs


def read(ctx):
    views = sum(r["valid_views"] for r in ctx.requests)
    if not views or ctx.window_s <= 0:
        return None
    flops = views * eva_forward_flops(ctx.config["vision"])
    return 100.0 * flops / (ctx.window_s * FLOPS_PER_S["bfloat16"])
