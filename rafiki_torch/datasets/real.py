"""Real data that needs no download.

The port's copy of ``rafiki_tpu/datasets/real.py``, split, named and
tagged as the reference does:

- ``prepare_sklearn_digits``: the UCI handwritten digits (1,797 real
  8×8 grayscale scans) as a packed image-dataset pair;
- ``prepare_sklearn_tabular``: the ``breast_cancer`` (binary), ``wine``
  (3 classes) and ``diabetes`` (regression) tables as CSV pairs;
- ``prepare_bundled_pos_corpus``: the hand-tagged English corpus in the
  repository, ``examples/datasets/english_pos/corpus.tsv`` (679
  sentences, the 12-tag Universal tagset), as a corpus zip pair.

``sklearn`` is imported inside the functions that need it: the card's
machine does not have it, and importing this module must not need it.
The bundled corpus needs nothing but the repository.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np

from ..model.dataset import (write_corpus_dataset, write_image_dataset_npz,
                             write_tabular_dataset)


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


def prepare_sklearn_tabular(name: str, out_dir: str, val_frac: float = 0.2,
                            seed: int = 0) -> Tuple[str, str]:
    """A table bundled with sklearn -> (train, val) CSV datasets.
    ``name``: ``breast_cancer``, ``wine`` or ``diabetes``."""
    import sklearn.datasets as skd

    loaders = {"breast_cancer": skd.load_breast_cancer,
               "wine": skd.load_wine, "diabetes": skd.load_diabetes}
    d = loaders[name]()
    features = np.asarray(d.data, dtype=np.float32)
    targets = np.asarray(d.target)
    tr, va = _split(len(targets), val_frac, seed)
    os.makedirs(out_dir, exist_ok=True)
    names = [str(n).replace(" ", "_") for n in
             getattr(d, "feature_names", range(features.shape[1]))]
    train = write_tabular_dataset(
        features[tr], targets[tr],
        os.path.join(out_dir, f"{name}_train.csv"), names)
    val = write_tabular_dataset(
        features[va], targets[va],
        os.path.join(out_dir, f"{name}_val.csv"), names)
    return train, val


#: The hand-tagged English corpus in the repository.
BUNDLED_POS_CORPUS = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))),
    "examples", "datasets", "english_pos", "corpus.tsv")


def prepare_bundled_pos_corpus(out_dir: str, val_frac: float = 0.2,
                               seed: int = 0,
                               corpus_tsv: str = "") -> Tuple[str, str]:
    """The bundled English POS corpus (or ``corpus_tsv``) -> (train,
    val) corpus zips, ``pos_train.zip`` and ``pos_val.zip``, with the
    sorted tag set of the whole corpus as both splits' vocabulary (see
    ``examples/datasets/english_pos/README.md`` for its sources)."""
    path = corpus_tsv or BUNDLED_POS_CORPUS
    sentences, tags = [], []
    cur_w: list = []
    cur_t: list = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.rstrip("\n")
            if not line:
                if cur_w:
                    sentences.append(cur_w)
                    tags.append(cur_t)
                    cur_w, cur_t = [], []
                continue
            w, t = line.split("\t")
            cur_w.append(w)
            cur_t.append(t)
    if cur_w:
        sentences.append(cur_w)
        tags.append(cur_t)

    tag_names = sorted({t for st in tags for t in st})
    tr, va = _split(len(sentences), val_frac, seed)
    os.makedirs(out_dir, exist_ok=True)
    train = write_corpus_dataset(
        [sentences[i] for i in tr], [tags[i] for i in tr],
        os.path.join(out_dir, "pos_train.zip"), tag_names)
    val = write_corpus_dataset(
        [sentences[i] for i in va], [tags[i] for i in va],
        os.path.join(out_dir, "pos_val.zip"), tag_names)
    return train, val
