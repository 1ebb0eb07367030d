"""The optimizer of the port's train loops.

The reference trains with ``optax.adamw`` under
``optax.warmup_cosine_decay_schedule``. The port pairs
``torch.optim.AdamW`` at optax's defaults (``betas=(0.9, 0.999)``,
``eps=1e-8``, ``weight_decay=1e-4``; torch's own default decay is 0.01)
with the same schedule, evaluated at the update count from 0 as optax
evaluates it.
"""

from __future__ import annotations

import math
from typing import Callable, Iterable

import torch

Schedule = Callable[[int], float]


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int,
                                 end_value: float) -> Schedule:
    """Linear warmup from ``init_value`` to ``peak_value`` over
    ``warmup_steps``, then cosine decay to ``end_value`` at
    ``decay_steps`` (which counts the warmup), as optax defines it."""
    cosine_steps = decay_steps - warmup_steps
    if not cosine_steps > 0:
        raise ValueError("the cosine decay requires positive decay_steps, "
                         f"got {cosine_steps}")
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = 1 - max(count, 0) / warmup_steps
            return (init_value - peak_value) * frac + peak_value
        c = min(count - warmup_steps, cosine_steps)
        cosine = 0.5 * (1 + math.cos(math.pi * c / cosine_steps))
        return peak_value * ((1 - alpha) * cosine + alpha)

    return schedule


def adamw(params: Iterable[torch.nn.Parameter], lr: float
          ) -> torch.optim.AdamW:
    """AdamW with optax ``adamw``'s defaults."""
    return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=1e-4)
