"""loader_wait_ms.train: the mean host wait a training step spends for its
batch, ms: `EventCLIPTrainer.step_times[i][0]` over the window's steps
(the loader's next batch and its placement on the card, as the trainer
records them)."""


def read(ctx):
    steps = getattr(ctx, "steps", None)
    if not steps:
        return None
    return 1e3 * sum(w for w, _ in steps) / len(steps)
