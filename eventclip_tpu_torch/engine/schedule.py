"""Learning-rate schedules.

Port of eventclip_tpu/engine/schedule.py. Behavioral contract: nerv's
`CosineAnnealingWarmupRestarts` as used by the reference (method.py:82-98,
150-193) — stepped per iteration with `first_cycle = total_steps` (so no
restart ever fires), linear warmup from `min_lr` to `max_lr` over
`warmup_steps_pct * total_steps`, then a single cosine decay back to
`min_lr = max_lr / 100`.
"""

from __future__ import annotations

import math
from typing import Callable


def warmup_cosine(
    max_lr: float,
    total_steps: int,
    warmup_pct: float = 0.05,
    min_lr_factor: float = 0.01,
) -> Callable[[int], float]:
    """step -> lr."""
    min_lr = max_lr * min_lr_factor
    warmup_steps = warmup_pct * total_steps

    def schedule(step: int) -> float:
        step = float(step)
        if step < warmup_steps:
            return min_lr + (max_lr - min_lr) * step / warmup_steps
        denom = max(total_steps - warmup_steps, 1.0)
        t = min(max((step - warmup_steps) / denom, 0.0), 1.0)
        return min_lr + (max_lr - min_lr) * 0.5 * (1.0 + math.cos(math.pi * t))

    return schedule
