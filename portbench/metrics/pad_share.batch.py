"""pad_share.batch: the share of the encoded view slots that are packing
padding, 100 x (1 - valid views / packed views), from the counts of the
program's `serve.pack` spans over the window: encoder work spent on
padding."""

from portbench import progspans


def read(ctx):
    packs = [r for r in progspans.recorded() if r.name == "serve.pack"]
    packed = sum(r.counts.get("packed_views", 0) for r in packs)
    if not packed or not ctx.requests:
        return None
    valid = sum(r.counts.get("valid_views", 0) for r in packs)
    return 100.0 * (1.0 - valid / packed)
