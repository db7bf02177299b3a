"""idle_outside_spans_ms.batch: device-idle time of the traced window
(`Trace.idle`) that lies under no root span of the program, ms a
request: near 0 when the program's spans share the trace's clock and
cover the host stages that leave the card idle.

It also prints one line on standard error: the window's idle time, ms a
request, by the innermost program span open over it (each span's time
less its children's), largest first; stages that hold no idle time are
left out."""

import sys

from portbench import progspans


def read(ctx):
    if ctx.trace is None or not ctx.requests:
        return None
    recs = progspans.recorded()
    if not recs:
        return None
    idle = progspans.Idle(ctx.trace.idle)
    n = len(ctx.requests)
    outside = progspans.idle_outside_roots(recs, idle, ctx.trace.lo,
                                           ctx.trace.hi)
    stages = sorted(progspans.idle_by_stage(recs, idle).items(),
                    key=lambda kv: -kv[1])
    print("[portbench] idle ms a request by program span: " + ", ".join(
        f"{name} {1e3 * s / n:.3f}" for name, s in stages)
        + f"; under no span {1e3 * outside / n:.3f}; idle in all "
        f"{1e3 * idle.total / n:.3f}", file=sys.stderr, flush=True)
    return 1e3 * outside / n
