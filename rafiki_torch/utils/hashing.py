"""A stateless integer hash for draws that a CUDA graph can capture.

Random draws that come from a generator's state repeat their first
draw on every replay of a captured graph. The port's samplers draw
instead from a hash of what names the draw (a seed, a step or position,
an index), computed on the device with integer ops, so eager runs and
graph replays give the same draws, bit for bit.
"""

from __future__ import annotations

import torch

M32 = 0xFFFFFFFF


def mix32(x: torch.Tensor) -> torch.Tensor:
    """A bijective 32-bit integer hash of int64 values in [0, 2^32);
    the multiplier keeps every product below 2^63."""
    x = ((x ^ (x >> 16)) * 0x45D9F3B) & M32
    x = ((x ^ (x >> 16)) * 0x45D9F3B) & M32
    return x ^ (x >> 16)
