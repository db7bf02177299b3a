"""idle_share.eva: the share of the traced EVA02 serving window in which no
operation ran on the card: 1 - (union of device intervals) / window, the
union over the trace's kernels, copies and sets alone: the device rows of
the program's `swiglu` ranges span from a range's first kernel to its
last and are no device work (as `idle_share.train` leaves out its
ranges)."""

from portbench import devtrace

RANGES = frozenset({"swiglu"})


def read(ctx):
    t = ctx.trace
    if t is None or t.window_s <= 0:
        return None
    work = [(max(a, t.lo), min(a + d, t.hi)) for name, a, d in t.kernels
            if name not in RANGES and a + d > t.lo and a < t.hi]
    return 100.0 * (1.0 - devtrace.union_length(work) / t.window_s)
