"""randaugment_ms.train: RandAugment's device time a training step, ms:
the device rows of the program's `randaugment` range (ops/rasterize.py,
around `ops.randaugment.apply_ops`) in the trace, each from the first to
the last kernel launched inside the range, averaged over the window's
steps (one range a step)."""

NAME = "randaugment"


def read(ctx):
    if ctx.trace is None:
        return None
    rows = [d for name, _, d in ctx.trace.kernels if name == NAME]
    if not rows:
        return None
    return 1e3 * sum(rows) / len(rows)
