"""enqueue_ms.batch: host ms of the program's `serve.enqueue` spans (the
host issuing the device step, which returns before the card finishes
it), a request. Near the device time, something in the step waits for
the card."""

from portbench import progspans


def read(ctx):
    return progspans.ms_a_request(ctx, ["serve.enqueue"])
