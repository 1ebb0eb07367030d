"""Dataset formats of the port: packed images and packed token ids.

The port's copy of the image and token parts of
``rafiki_tpu/model/dataset.py``, with the same ``.npz`` formats:

- images (IMAGE_CLASSIFICATION): ``images`` ``(N, H, W, C)`` uint8,
  ``labels`` ``(N,)`` int64, ``n_classes``;
- token ids (LANGUAGE_MODELING): ``ids`` int32 + ``vocab_size``.

The reference's host dataset cache is not ported: each load parses the
file. The zip-of-PNGs image encoding needs PIL, which the card's machine
does not have, and is not ported either.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Optional, Sequence, Tuple

import numpy as np


@dataclass
class ImageDataset:
    """An in-memory image-classification dataset (ref
    ``model/dataset.py:50``)."""

    images: np.ndarray  # (N, H, W, C) uint8
    labels: np.ndarray  # (N,) int64
    n_classes: int

    @property
    def size(self) -> int:
        return int(self.images.shape[0])

    @property
    def image_shape(self) -> Tuple[int, int, int]:
        return tuple(self.images.shape[1:])  # type: ignore[return-value]


def load_image_dataset(dataset_path: str) -> ImageDataset:
    """Load a packed ``.npz`` image-classification dataset (ref
    ``model/dataset.py:350``)."""
    if not dataset_path.endswith(".npz"):
        raise ValueError(f"unsupported image dataset {dataset_path}: the "
                         "port reads the packed .npz encoding only")
    with np.load(dataset_path) as z:
        images = np.asarray(z["images"], dtype=np.uint8)
        labels = np.asarray(z["labels"], dtype=np.int64)
        n_classes = (int(z["n_classes"]) if "n_classes" in z
                     else int(labels.max()) + 1)
    if images.ndim == 3:  # grayscale without channel dim
        images = images[..., None]
    return ImageDataset(images=images, labels=labels, n_classes=n_classes)


def write_image_dataset_npz(images: np.ndarray, labels: np.ndarray,
                            out_path: str,
                            n_classes: Optional[int] = None) -> str:
    """Write the packed image encoding (ref ``model/dataset.py:494``);
    returns the path, with ``.npz`` appended when it was missing."""
    images = np.asarray(images, dtype=np.uint8)
    if images.ndim == 3:
        images = images[..., None]
    labels = np.asarray(labels, dtype=np.int64)
    if n_classes is None:
        n_classes = int(labels.max()) + 1
    out = out_path if out_path.endswith(".npz") else out_path + ".npz"
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    np.savez_compressed(out, images=images, labels=labels,
                        n_classes=n_classes)
    return out


def normalize_query(q: Any, expected_shape: Sequence[int]) -> np.ndarray:
    """One prediction query as a float32 image of ``expected_shape``
    (ref ``model/dataset.py:578``): a 2-D query gains a channel axis,
    uint8 is scaled to [0, 1], a shape mismatch raises ``ValueError``."""
    arr = np.asarray(q)
    if arr.ndim == 2:
        arr = arr[..., None]
    if tuple(arr.shape) != tuple(expected_shape):
        raise ValueError(
            f"query shape {arr.shape} != {tuple(expected_shape)}")
    if arr.dtype == np.uint8:
        arr = arr.astype(np.float32) / 255.0
    return arr.astype(np.float32)


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
