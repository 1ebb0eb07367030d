"""Model-FLOPs utilization of a train loop.

The port's copy of ``MfuMeter`` from ``rafiki_tpu/observe/profiling.py``,
without that module's peak probe: the caller states the card's peak.
"""

from __future__ import annotations

import time
from typing import Optional

# One NVIDIA H100 SXM, dense bf16 tensor cores (NVIDIA data sheet, at
# the full 700 W power limit).
H100_PEAK_BF16_FLOPS = 989e12


class MfuMeter:
    """Accumulates step counts against wall time → achieved FLOP/s and
    MFU.

    ``flops_per_step`` is the cost of one train step and ``peak`` the
    card's FLOP/s. Without a peak (a run on the CPU, which has no spec
    sheet here) ``mfu`` is None.
    """

    def __init__(self, flops_per_step: float, peak: Optional[float]):
        self.flops_per_step = flops_per_step
        self.peak = peak
        self.n_steps = 0
        self._t0 = time.monotonic()

    def tick(self, n_steps: int) -> None:
        self.n_steps += n_steps

    def reset(self) -> None:
        """Restart the measurement window (after a warm-up step that is
        not part of steady-state utilization)."""
        self.n_steps = 0
        self._t0 = time.monotonic()

    @property
    def mfu(self) -> Optional[float]:
        """Fraction of peak [0, ~1], or None without a peak or a step."""
        if not self.peak or self.n_steps == 0:
            return None
        elapsed = max(time.monotonic() - self._t0, 1e-9)
        return self.flops_per_step * self.n_steps / elapsed / self.peak
