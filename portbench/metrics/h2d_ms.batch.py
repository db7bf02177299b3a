"""h2d_ms.batch: host ms of the program's `serve.place` spans (the copies
of a chunk's packed windows, mask and view ids to the card), a
request."""

from portbench import progspans


def read(ctx):
    return progspans.ms_a_request(ctx, ["serve.place"])
