"""host_window_ms.batch: host-clock ms of `serve.Predictor.gather_windows`
(validation, centring, windowing, packing; the native library where it
loads), the harness's span around the call, mean a request."""


def read(ctx):
    t = ctx.spans.get("host_window")
    return 1e3 * sum(t) / len(t) if t else None
