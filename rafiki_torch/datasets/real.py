"""Real data that ships inside scikit-learn.

The port's copy of ``prepare_sklearn_digits`` from
``rafiki_tpu/datasets/real.py``: the UCI handwritten digits (1,797 real
8×8 grayscale scans) as a packed image-dataset pair, split as the
reference splits them. ``sklearn`` is imported inside the function: the
card's machine does not have it, and importing this module must not
need it.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np

from ..model.dataset import write_image_dataset_npz


def _split(n: int, val_frac: float, seed: int) -> Tuple[np.ndarray,
                                                        np.ndarray]:
    rng = np.random.default_rng(seed)
    order = rng.permutation(n)
    n_val = max(1, int(n * val_frac))
    return order[n_val:], order[:n_val]


def prepare_sklearn_digits(out_dir: str, val_frac: float = 0.2,
                           seed: int = 0) -> Tuple[str, str]:
    """UCI digits -> (train, val) packed image datasets."""
    from sklearn.datasets import load_digits

    d = load_digits()
    # 0..16 integer pixel values -> uint8 0..255 image convention.
    images = (d.images / 16.0 * 255).astype(np.uint8)[..., None]
    labels = d.target.astype(np.int64)
    tr, va = _split(len(labels), val_frac, seed)
    os.makedirs(out_dir, exist_ok=True)
    train = write_image_dataset_npz(
        images[tr], labels[tr], os.path.join(out_dir, "digits_train.npz"),
        10)
    val = write_image_dataset_npz(
        images[va], labels[va], os.path.join(out_dir, "digits_val.npz"), 10)
    return train, val
