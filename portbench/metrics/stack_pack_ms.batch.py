"""stack_pack_ms.batch: host ms of the program's `serve.stack` (`np.stack`
of the per-stream windows) and `serve.pack` (`pack_view_batch`) spans,
the two host copies of a request's windows, summed, a request."""

from portbench import progspans


def read(ctx):
    return progspans.ms_a_request(ctx, ["serve.stack", "serve.pack"])
