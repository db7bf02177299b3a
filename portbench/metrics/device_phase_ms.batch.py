"""device_phase_ms.batch: host-clock ms of `serve.Predictor.predict_windows`
(packing, placement, K1 and the frames, the encoder, the head, the fetch
that waits for the card), the harness's span around the call, mean a
request."""


def read(ctx):
    t = ctx.spans.get("device_phase")
    return 1e3 * sum(t) / len(t) if t else None
