"""Dataset formats of the port: images, token ids, corpora and tables.

The port's copy of ``rafiki_tpu/model/dataset.py``, with the same
formats:

- images (IMAGE_CLASSIFICATION): ``.npz`` with ``images`` ``(N, H, W,
  C)`` uint8, ``labels`` ``(N,)`` int64, ``n_classes``;
- token ids (LANGUAGE_MODELING): ``.npz`` with ``ids`` int32 +
  ``vocab_size``;
- tagged corpora (POS_TAGGING, ref :99-147 and :399-426): a zip of
  ``tags.txt`` (one tag a line) and ``corpus.tsv`` (``token<TAB>tag``
  lines, a blank line between sentences); tokens map to embedding rows
  by ``hash_token_ids``;
- tables (TABULAR_*, ref :82-97 and :432-492): a CSV with a header
  row, the label the last column unless named; integral labels make a
  classification set.

The reference's host dataset cache is not ported: each load parses the
file. The zip-of-PNGs image encoding needs PIL, which the card's machine
does not have, and is not ported either.
"""

from __future__ import annotations

import csv
import os
import zipfile
from dataclasses import dataclass
from typing import Any, List, Optional, Sequence, Tuple

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


@dataclass
class CorpusDataset:
    """A token-tagged corpus (ref ``model/dataset.py:99``)."""

    sentences: List[List[str]]
    tags: List[List[int]]
    tag_names: List[str]

    @property
    def size(self) -> int:
        return len(self.sentences)


#: Embedding row 0 is padding; ``hash_token_ids`` gives ids >= 1.
PAD_ID = 0


def hash_token_ids(tokens: List[str], vocab_size: int,
                   max_len: int) -> np.ndarray:
    """``max_len`` int32 ids: ``1 + crc32(token) mod (vocab_size − 1)``
    for the first ``max_len`` tokens, ``PAD_ID`` after (ref :131-147):
    no fitted vocabulary, the same ids in every process."""
    import zlib

    ids = np.zeros((max_len,), np.int32)
    for i, tok in enumerate(tokens[:max_len]):
        ids[i] = 1 + (zlib.crc32(tok.encode("utf-8")) % (vocab_size - 1))
    return ids


def load_corpus_dataset(dataset_path: str) -> CorpusDataset:
    """Load a token-tagged corpus (a zip of ``corpus.tsv`` and
    ``tags.txt``; ref :399-426)."""
    with zipfile.ZipFile(dataset_path) as zf:
        tag_names = [t for t in
                     zf.read("tags.txt").decode("utf-8").split("\n") if t]
        tag_to_id = {t: i for i, t in enumerate(tag_names)}
        sentences: List[List[str]] = []
        tags: List[List[int]] = []
        cur_toks: List[str] = []
        cur_tags: List[int] = []
        for line in zf.read("corpus.tsv").decode("utf-8").split("\n"):
            line = line.rstrip("\r")
            if not line:
                if cur_toks:
                    sentences.append(cur_toks)
                    tags.append(cur_tags)
                    cur_toks, cur_tags = [], []
                continue
            tok, tag = line.split("\t")
            cur_toks.append(tok)
            cur_tags.append(tag_to_id[tag])
        if cur_toks:
            sentences.append(cur_toks)
            tags.append(cur_tags)
    return CorpusDataset(sentences=sentences, tags=tags, tag_names=tag_names)


def write_corpus_dataset(sentences: List[List[str]], tags: List[List[str]],
                         out_path: str,
                         tag_names: Optional[List[str]] = None) -> str:
    """Write the corpus zip (ref :533-550). An explicit ``tag_names``
    keeps the tag ids of two splits alike when a rare tag is missing
    from one."""
    if tag_names is None:
        tag_names = sorted({t for sent in tags for t in sent})
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with zipfile.ZipFile(out_path, "w", zipfile.ZIP_DEFLATED) as zf:
        zf.writestr("tags.txt", "\n".join(tag_names) + "\n")
        lines: List[str] = []
        for sent, stags in zip(sentences, tags):
            for tok, tag in zip(sent, stags):
                lines.append(f"{tok}\t{tag}")
            lines.append("")
        zf.writestr("corpus.tsv", "\n".join(lines) + "\n")
    return out_path


@dataclass
class TabularDataset:
    """Rows of numeric features with a label or target column (ref
    :82-97); ``n_classes`` is set when the target is integral and None
    for regression."""

    features: np.ndarray  # (N, D) float32
    targets: np.ndarray   # (N,) int64 (classification) or float32
    feature_names: List[str]
    target_name: str
    n_classes: Optional[int]

    @property
    def size(self) -> int:
        return int(self.features.shape[0])


def load_tabular_dataset(dataset_path: str,
                         label_col: Optional[str] = None) -> TabularDataset:
    """Load a CSV table with a header row and numeric cells (ref
    :432-476); ``label_col`` defaults to the last column."""
    with open(dataset_path, newline="", encoding="utf-8") as f:
        rows = list(csv.reader(f))
    if len(rows) < 2:
        raise ValueError(f"tabular dataset {dataset_path} has no data rows")
    header, data = rows[0], rows[1:]
    if label_col is None:
        label_idx = len(header) - 1
    else:
        if label_col not in header:
            raise ValueError(f"label column {label_col!r} not in {header}")
        label_idx = header.index(label_col)
    values = np.asarray(data, dtype=np.float64)
    targets64 = values[:, label_idx]
    features = np.delete(values, label_idx, axis=1).astype(np.float32)
    feature_names = [h for i, h in enumerate(header) if i != label_idx]
    if np.all(targets64 == np.round(targets64)):
        targets = targets64.astype(np.int64)
        n_classes: Optional[int] = int(targets.max()) + 1
    else:
        targets = targets64.astype(np.float32)
        n_classes = None
    return TabularDataset(features=features, targets=targets,
                          feature_names=feature_names,
                          target_name=header[label_idx], n_classes=n_classes)


def write_tabular_dataset(features: np.ndarray, targets: np.ndarray,
                          out_path: str,
                          feature_names: Optional[List[str]] = None,
                          target_name: str = "label") -> str:
    """Write the CSV table (ref :479-492)."""
    features = np.asarray(features)
    if feature_names is None:
        feature_names = [f"f{i}" for i in range(features.shape[1])]
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "w", newline="", encoding="utf-8") as f:
        w = csv.writer(f)
        w.writerow(list(feature_names) + [target_name])
        for x, y in zip(features, np.asarray(targets)):
            w.writerow([repr(float(v)) for v in x] + [repr(float(y))])
    return out_path
