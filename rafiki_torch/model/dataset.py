"""Packed token-id datasets (the LANGUAGE_MODELING task).

The port's copy of the token part of ``rafiki_tpu/model/dataset.py``:
the same ``.npz`` format (``ids`` int32 + ``vocab_size``), without the
reference's host dataset cache.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class TokenDataset:
    """A packed token-id stream: one flat id array a model windows into
    (seq_len+1)-long examples."""

    ids: np.ndarray        # (n,) int32 token ids in [0, vocab_size)
    vocab_size: int

    @property
    def size(self) -> int:
        return int(self.ids.shape[0])


def load_token_dataset(dataset_path: str) -> TokenDataset:
    """Load a packed token-id dataset (.npz with ``ids`` +
    ``vocab_size``)."""
    with np.load(dataset_path) as z:
        ids = np.asarray(z["ids"], dtype=np.int32)
        vocab_size = int(z["vocab_size"])
    if ids.ndim != 1:
        raise ValueError(f"token dataset must be 1-D, got {ids.shape}")
    if ids.size and (ids.min() < 0 or ids.max() >= vocab_size):
        raise ValueError("token ids out of range for vocab_size "
                         f"{vocab_size}")
    return TokenDataset(ids=ids, vocab_size=vocab_size)


def write_token_dataset(ids: np.ndarray, vocab_size: int,
                        path: str) -> str:
    ids = np.asarray(ids, dtype=np.int32)
    out = path if path.endswith(".npz") else path + ".npz"
    np.savez_compressed(out, ids=ids, vocab_size=np.int64(vocab_size))
    return out
