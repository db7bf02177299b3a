"""stream_prep_ms.batch: host ms of the program's per-stream spans
`serve.canonical` (the float32 copy and polarity map), `serve.centre`
(`prepare_stream`) and `serve.window` (`gather_event_windows`; the native
library where it loads), summed, a request."""

from portbench import progspans


def read(ctx):
    return progspans.ms_a_request(
        ctx, ["serve.canonical", "serve.centre", "serve.window"])
