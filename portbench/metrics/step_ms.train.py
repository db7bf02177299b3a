"""step_ms.train: the mean time of a training step, ms:
`EventCLIPTrainer.step_times[i][1]` over the window's steps (the step
from its call through the device synchronize that ends it)."""


def read(ctx):
    steps = getattr(ctx, "steps", None)
    if not steps:
        return None
    return 1e3 * sum(s for _, s in steps) / len(steps)
