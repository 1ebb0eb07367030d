"""Shared transformer pieces: the counterpart of the reference's
``models/transformer.py``. Only the sinusoidal position table is ported
so far; the tagger itself is not."""

from __future__ import annotations

import math

import numpy as np


def _sinusoidal(max_len: int, dim: int) -> np.ndarray:
    pos = np.arange(max_len)[:, None]
    div = np.exp(np.arange(0, dim, 2) * (-math.log(10000.0) / dim))
    pe = np.zeros((max_len, dim), np.float32)
    pe[:, 0::2] = np.sin(pos * div)
    pe[:, 1::2] = np.cos(pos * div)
    return pe
