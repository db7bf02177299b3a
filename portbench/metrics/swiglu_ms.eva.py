"""swiglu_ms.eva: the device time of the EVA02 MLP's glue a request, ms:
the device rows of the program's `swiglu` ranges (models/clip/eva.py,
around SiLU(gate) * value, `ffn_ln` and the pad, between the W1/W2 and W3
products), each from the first to the last kernel launched inside the
range, summed over the window and divided by its requests (24 ranges a
request)."""

NAME = "swiglu"


def read(ctx):
    if ctx.trace is None or not ctx.requests:
        return None
    rows = [d for name, _, d in ctx.trace.kernels if name == NAME]
    if not rows:
        return None
    return 1e3 * sum(rows) / len(ctx.requests)
