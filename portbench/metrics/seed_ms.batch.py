"""seed_ms.batch: host ms of the program's `serve.seed` spans (the
`zlib.crc32` of each stream's float32 copy that seeds its view draws),
summed over the window's streams, a request."""

from portbench import progspans


def read(ctx):
    return progspans.ms_a_request(ctx, ["serve.seed"])
