"""idle_share.train: the share of the traced training window in which no
operation ran on the card: 1 - (union of device intervals) / window.

The union is taken here over the trace's kernels, copies and sets alone:
the device rows of the program's own `record_function` ranges (RANGES)
span from a range's first kernel to its last, gaps included, and are no
device work."""

from portbench import devtrace

# the ranges the program opens (ops/rasterize.py, models/classifier.py)
RANGES = frozenset({"randaugment", "adapter", "text_feats"})


def read(ctx):
    t = ctx.trace
    if t is None or t.window_s <= 0:
        return None
    work = [(max(a, t.lo), min(a + d, t.hi)) for name, a, d in t.kernels
            if name not in RANGES and a + d > t.lo and a < t.hi]
    return 100.0 * (1.0 - devtrace.union_length(work) / t.window_s)
