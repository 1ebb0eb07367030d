"""Synthetic learnable token streams for tests and the chip smoke run.

The port's copy of ``make_synthetic_token_dataset`` from
``rafiki_tpu/datasets/synth.py``: the same seed gives the same stream in
both packages.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np

from ..model.dataset import write_token_dataset


def make_synthetic_token_dataset(
        out_dir: str,
        n_train: int = 1 << 20,
        n_val: int = 1 << 16,
        vocab_size: int = 32768,
        branching: int = 4,
        seed: int = 0) -> Tuple[str, str]:
    """Write train/val packed token streams; returns their paths.

    The stream is an order-1 Markov chain where every token has
    ``branching`` equally likely successors (a fixed random successor
    table), so the signal is learnable: a working LM's loss converges
    toward the chain's entropy (``log(branching)`` nats) and its top-1
    next-token accuracy toward ``1/branching``, far above the
    ``1/vocab_size`` chance floor a broken model sits at.
    """
    rng = np.random.default_rng(seed)
    successors = rng.integers(0, vocab_size,
                              size=(vocab_size, branching), dtype=np.int32)

    def make(n, seed2):
        r = np.random.default_rng(seed2)
        cols = r.integers(0, branching, size=n, dtype=np.int32)
        ids = np.empty((n,), np.int32)
        cur = np.int32(r.integers(0, vocab_size))
        for i in range(n):
            ids[i] = cur
            cur = successors[cur, cols[i]]
        return ids

    os.makedirs(out_dir, exist_ok=True)
    train_path = write_token_dataset(
        make(n_train, seed + 1), vocab_size,
        os.path.join(out_dir, "synthlm_train.npz"))
    val_path = write_token_dataset(
        make(n_val, seed + 2), vocab_size,
        os.path.join(out_dir, "synthlm_val.npz"))
    return train_path, val_path
