"""Data order of hand-rolled train loops.

The port's copy of ``epoch_rng`` from ``rafiki_tpu/model/loop_ckpt.py``
(the rest of that module, checkpoint-resume, is not ported yet).
"""

from __future__ import annotations

import numpy as np


def epoch_rng(seed: int, epoch: int) -> np.random.Generator:
    """Per-epoch host RNG: epoch k's data order is a pure function of
    (seed, k), so a run resumed at epoch k visits the same data as an
    uninterrupted run, and both packages cut the same windows."""
    return np.random.default_rng((int(seed) + 1) * 100003 + epoch)
