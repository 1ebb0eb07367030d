"""Converters of the standard distribution files of fashion-MNIST and
CIFAR-10 into the platform's packed image format.

The port's copy of ``rafiki_tpu/datasets/prep.py``. Both read only
files already on disk (no download):

- fashion-MNIST: the IDX ubyte files (``train-images-idx3-ubyte`` and
  the three others), plain or gzipped; a wrong magic number raises;
- CIFAR-10: the python pickle batches (``cifar-10-batches-py/``).

``python -m rafiki_torch.datasets.prep fashion_mnist|cifar10 --out-dir
D (--raw-dir R | --synthetic)`` is the counterpart of the reference's
CLI wrappers ``examples/datasets/{fashion_mnist,cifar10}.py``, with
their arguments and their shape-identical synthetic stand-in.
"""

from __future__ import annotations

import gzip
import os
import pickle
import struct
from typing import Optional, Tuple

import numpy as np

from ..model.dataset import write_image_dataset_npz


def _open_maybe_gz(path: str):
    if path.endswith(".gz"):
        return gzip.open(path, "rb")
    return open(path, "rb")


def _find(raw_dir: str, stem: str) -> Optional[str]:
    for suffix in ("", ".gz"):
        p = os.path.join(raw_dir, stem + suffix)
        if os.path.exists(p):
            return p
    return None


def _read_idx_images(path: str) -> np.ndarray:
    with _open_maybe_gz(path) as f:
        magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
        if magic != 0x803:
            raise ValueError(f"{path}: bad IDX image magic {magic:#x}")
        data = np.frombuffer(f.read(), np.uint8)
    return data.reshape(n, rows, cols, 1)


def _read_idx_labels(path: str) -> np.ndarray:
    with _open_maybe_gz(path) as f:
        magic, n = struct.unpack(">II", f.read(8))
        if magic != 0x801:
            raise ValueError(f"{path}: bad IDX label magic {magic:#x}")
        return np.frombuffer(f.read(), np.uint8).astype(np.int64)


def prepare_fashion_mnist(raw_dir: str, out_dir: str,
                          val_frac: float = 0.0) -> Tuple[str, str]:
    """Convert IDX files in ``raw_dir`` → train/val npz datasets.

    ``val_frac`` > 0 carves the validation set out of the train split
    (upstream evaluates on the test split; pass 0 to do the same with the
    t10k files).
    """
    files = {stem: _find(raw_dir, stem) for stem in (
        "train-images-idx3-ubyte", "train-labels-idx1-ubyte",
        "t10k-images-idx3-ubyte", "t10k-labels-idx1-ubyte")}
    missing = [s for s, p in files.items() if p is None]
    if missing:
        raise FileNotFoundError(
            f"fashion-MNIST files missing under {raw_dir}: {missing}")
    tr_x = _read_idx_images(files["train-images-idx3-ubyte"])
    tr_y = _read_idx_labels(files["train-labels-idx1-ubyte"])
    te_x = _read_idx_images(files["t10k-images-idx3-ubyte"])
    te_y = _read_idx_labels(files["t10k-labels-idx1-ubyte"])
    if val_frac > 0:
        n_val = int(len(tr_x) * val_frac)
        te_x, te_y = tr_x[-n_val:], tr_y[-n_val:]
        tr_x, tr_y = tr_x[:-n_val], tr_y[:-n_val]
    os.makedirs(out_dir, exist_ok=True)
    train_path = write_image_dataset_npz(
        tr_x, tr_y, os.path.join(out_dir, "fashion_mnist_train.npz"), 10)
    val_path = write_image_dataset_npz(
        te_x, te_y, os.path.join(out_dir, "fashion_mnist_val.npz"), 10)
    return train_path, val_path


def prepare_cifar10(raw_dir: str, out_dir: str) -> Tuple[str, str]:
    """Convert ``cifar-10-batches-py`` pickles → train/val npz datasets."""
    batch_dir = raw_dir
    if os.path.isdir(os.path.join(raw_dir, "cifar-10-batches-py")):
        batch_dir = os.path.join(raw_dir, "cifar-10-batches-py")

    def read_batch(name: str):
        p = os.path.join(batch_dir, name)
        if not os.path.exists(p):
            raise FileNotFoundError(f"CIFAR-10 batch missing: {p}")
        with open(p, "rb") as f:
            d = pickle.load(f, encoding="bytes")
        x = np.asarray(d[b"data"], np.uint8).reshape(-1, 3, 32, 32)
        return x.transpose(0, 2, 3, 1), np.asarray(d[b"labels"], np.int64)

    xs, ys = zip(*[read_batch(f"data_batch_{i}") for i in range(1, 6)])
    tr_x, tr_y = np.concatenate(xs), np.concatenate(ys)
    te_x, te_y = read_batch("test_batch")
    os.makedirs(out_dir, exist_ok=True)
    train_path = write_image_dataset_npz(
        tr_x, tr_y, os.path.join(out_dir, "cifar10_train.npz"), 10)
    val_path = write_image_dataset_npz(
        te_x, te_y, os.path.join(out_dir, "cifar10_val.npz"), 10)
    return train_path, val_path


#: name -> (converter, the synthetic stand-in's image shape)
_SETS = {"fashion_mnist": (prepare_fashion_mnist, (28, 28, 1)),
         "cifar10": (prepare_cifar10, (32, 32, 3))}


def main(argv: Optional[list] = None) -> None:
    import argparse

    p = argparse.ArgumentParser(prog="python -m rafiki_torch.datasets.prep")
    p.add_argument("dataset", choices=sorted(_SETS))
    p.add_argument("--out-dir", required=True)
    p.add_argument("--raw-dir", help="directory with the raw files")
    p.add_argument("--synthetic", action="store_true",
                   help="generate a synthetic stand-in instead")
    args = p.parse_args(argv)
    convert, shape = _SETS[args.dataset]
    if args.synthetic:
        from .synth import make_synthetic_image_dataset
        train, val = make_synthetic_image_dataset(
            args.out_dir, n_train=8192, n_val=1024, image_shape=shape,
            n_classes=10, name=args.dataset)
    else:
        if not args.raw_dir:
            raise SystemExit("--raw-dir or --synthetic is required")
        train, val = convert(args.raw_dir, args.out_dir)
    print("train:", train)
    print("val:  ", val)


if __name__ == "__main__":
    main()
