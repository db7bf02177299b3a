"""fetch_wait_ms.batch: host ms of the program's `serve.fetch` spans (the
host waiting for the card to finish the request, then the copy of the
probabilities back), a request."""

from portbench import progspans


def read(ctx):
    return progspans.ms_a_request(ctx, ["serve.fetch"])
