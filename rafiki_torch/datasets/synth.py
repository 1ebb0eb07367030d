"""Synthetic learnable datasets for tests and the chip smoke run.

The port's copies of ``make_synthetic_image_dataset``,
``make_synthetic_corpus_dataset``, ``make_synthetic_tabular_dataset``
and ``make_synthetic_token_dataset`` from
``rafiki_tpu/datasets/synth.py``:
they draw from the same generators in the same order, so the same seed
writes the same bytes in both packages.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np

from ..model.dataset import (write_corpus_dataset, write_image_dataset_npz,
                             write_tabular_dataset, write_token_dataset)


def make_synthetic_image_dataset(
        out_dir: str,
        n_train: int = 512,
        n_val: int = 128,
        image_shape: Tuple[int, int, int] = (28, 28, 1),
        n_classes: int = 10,
        noise: float = 0.25,
        seed: int = 0,
        name: str = "synth") -> Tuple[str, str]:
    """Write train/val packed image datasets; returns their paths.

    Each class has a random template; an image is its class's template
    plus Gaussian noise, clipped to [0, 1] and stored as uint8. A working
    classifier separates the classes; a broken one stays at chance.
    """
    rng = np.random.default_rng(seed)
    templates = rng.uniform(0, 1, size=(n_classes, *image_shape))

    def make(n, seed2):
        r = np.random.default_rng(seed2)
        labels = r.integers(0, n_classes, size=n)
        imgs = templates[labels] + r.normal(0, noise, size=(n, *image_shape))
        imgs = np.clip(imgs, 0, 1)
        return (imgs * 255).astype(np.uint8), labels

    os.makedirs(out_dir, exist_ok=True)
    tr_imgs, tr_labels = make(n_train, seed + 1)
    va_imgs, va_labels = make(n_val, seed + 2)
    train_path = write_image_dataset_npz(
        tr_imgs, tr_labels, os.path.join(out_dir, f"{name}_train.npz"),
        n_classes)
    val_path = write_image_dataset_npz(
        va_imgs, va_labels, os.path.join(out_dir, f"{name}_val.npz"),
        n_classes)
    return train_path, val_path


def make_synthetic_corpus_dataset(
        out_dir: str,
        n_train: int = 256,
        n_val: int = 64,
        vocab: int = 120,
        n_tags: int = 5,
        max_len: int = 12,
        seed: int = 0,
        name: str = "pos") -> Tuple[str, str]:
    """Write train/val POS-style corpora; returns their paths.

    Each vocabulary word has a fixed majority tag, with 5% of tokens
    tagged at random, so a working tagger beats chance by a wide margin.
    Sentence lengths are uniform in [3, ``max_len``]."""
    rng = np.random.default_rng(seed)
    words = [f"w{i}" for i in range(vocab)]
    word_tag = rng.integers(0, n_tags, size=vocab)
    tag_names = [f"TAG{i}" for i in range(n_tags)]

    def make(n, seed2):
        r = np.random.default_rng(seed2)
        sents, tags = [], []
        for _ in range(n):
            length = int(r.integers(3, max_len + 1))
            ids = r.integers(0, vocab, size=length)
            sents.append([words[i] for i in ids])
            noisy = np.where(r.random(length) < 0.05,
                             r.integers(0, n_tags, size=length),
                             word_tag[ids])
            tags.append([tag_names[t] for t in noisy])
        return sents, tags

    os.makedirs(out_dir, exist_ok=True)
    tr = make(n_train, seed + 1)
    va = make(n_val, seed + 2)
    train_path = write_corpus_dataset(
        tr[0], tr[1], os.path.join(out_dir, f"{name}_train.zip"),
        tag_names=tag_names)
    val_path = write_corpus_dataset(
        va[0], va[1], os.path.join(out_dir, f"{name}_val.zip"),
        tag_names=tag_names)
    return train_path, val_path


def make_synthetic_tabular_dataset(
        out_dir: str,
        n_train: int = 512,
        n_val: int = 128,
        n_features: int = 8,
        n_classes: int = 0,
        seed: int = 0,
        name: str = "tab") -> Tuple[str, str]:
    """Write train/val tabular CSVs; returns their paths.

    ``n_classes > 0``: classification, the argmax of a noisy linear
    score per class; ``n_classes == 0``: regression on a noisy linear
    target."""
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(n_features, max(n_classes, 1)))

    def make(n, seed2):
        r = np.random.default_rng(seed2)
        x = r.normal(size=(n, n_features)).astype(np.float32)
        scores = x @ w + 0.1 * r.normal(size=(n, max(n_classes, 1)))
        if n_classes > 0:
            y = scores.argmax(axis=1).astype(np.int64)
        else:
            y = scores[:, 0].astype(np.float32)
        return x, y

    os.makedirs(out_dir, exist_ok=True)
    tr_x, tr_y = make(n_train, seed + 1)
    va_x, va_y = make(n_val, seed + 2)
    train_path = write_tabular_dataset(
        tr_x, tr_y, os.path.join(out_dir, f"{name}_train.csv"))
    val_path = write_tabular_dataset(
        va_x, va_y, os.path.join(out_dir, f"{name}_val.csv"))
    return train_path, val_path


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
