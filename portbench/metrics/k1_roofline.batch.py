"""k1_roofline.batch: K1 (csrc/histogram.cu, `eventclip::event_histogram`)
in the serving window, its bound over its device time. A launch reads the
[K, N, 3] int16 packed windows and writes [K, 2, H, W] float32 counts;
the bound is those bytes over the memory bandwidth (the counting itself
is one add an event). Kernels are matched by name in the trace."""

from portbench.peaks import bound_s

KERNELS = ("hist_kernel",)


def k1_bound_s(views: int, window: int, height: int, width: int) -> float:
    nbytes = views * window * 3 * 2 + views * 2 * height * width * 4
    return bound_s(nbytes, views * window, "float32")


def read(ctx):
    if ctx.trace is None or not ctx.requests:
        return None
    ks = ctx.trace.matching(KERNELS)
    if not ks:
        return None
    g = ctx.geometry
    per_launch = sum(k1_bound_s(r["bucket"], g["window"], g["height"],
                                g["width"]) for r in ctx.requests) \
        / len(ctx.requests)
    return 100.0 * per_launch * len(ks) / sum(d for _, _, d in ks)
