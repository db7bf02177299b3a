"""Faults a training cell can have, planted underneath the trainer.

Each takes `patch(owner, name, value)` (pytest's `monkeypatch.setattr`,
or `faults.Patches`) and breaks the path a run's checked steps take; a
run with one planted has to come out not correct. One card: there is no
exchange between cards to leave out. `control_train.py --fault <name>`
reads them on the card, the tests on the CPU.
"""

from __future__ import annotations


def stale(patch):
    """A step that returns its state unchanged: the update counted, the
    parameters and Adam's moments left as they were."""
    from eventclip_tpu_torch.engine.optim import Optimizer

    def step(self):
        self.count += 1
    patch(Optimizer, "step", step)


def half(patch):
    """Half of the batch left out, the loss's mean taken over the rest."""
    from eventclip_tpu_torch.engine import train
    from eventclip_tpu_torch.models.classifier import per_sample_ce

    def loss(cfg, out, labels):
        ce = per_sample_ce(cfg, out, labels)
        return {"ce_loss": ce[:len(ce) // 2].mean()}
    patch(train, "train_loss", loss)


def no_randaugment(patch):
    """RandAugment skipped: the frames go to the resize as rasterised."""
    from eventclip_tpu_torch.ops import rasterize

    patch(rasterize, "apply_ops",
          lambda frames, op_idx, mag, fill=255.0: frames)


def tower_lr(patch):
    """The tower's leaves stepped at `lr` (the text features') instead of
    `clip_lr`."""
    from eventclip_tpu_torch.engine.optim import Optimizer

    init = Optimizer.__init__

    def f(self, *a, **k):
        init(self, *a, **k)
        self.schedules["visual"] = self.schedules["base"]
    patch(Optimizer, "__init__", f)


def altered(patch):
    """The answer altered where it is produced: each sample's loss taken
    against the next class's label."""
    from eventclip_tpu_torch.engine import train
    from eventclip_tpu_torch.models.classifier import per_sample_ce

    def loss(cfg, out, labels):
        n = out["logits"].shape[-1]
        return {"ce_loss": per_sample_ce(cfg, out, (labels + 1) % n).mean()}
    patch(train, "train_loss", loss)


FAULTS = {"stale": stale, "half": half, "no_randaugment": no_randaugment,
          "tower_lr": tower_lr, "altered": altered}
