"""Dataset formats of the port: images, token ids, corpora and tables.

The port's copy of ``rafiki_tpu/model/dataset.py``, with the same
formats:

- images (IMAGE_CLASSIFICATION): ``.npz`` with ``images`` ``(N, H, W,
  C)`` uint8, ``labels`` ``(N,)`` int64, ``n_classes``; or the
  reference-compatible ``.zip`` of PNG files with an ``images.csv``
  index (``path,class``; ref :379-396, :508-530), read and written with
  PIL, which is imported inside those functions only (the card's
  machine has no PIL);
- token ids (LANGUAGE_MODELING): ``.npz`` with ``ids`` int32 +
  ``vocab_size``;
- tagged corpora (POS_TAGGING, ref :99-147 and :399-426): a zip of
  ``tags.txt`` (one tag a line) and ``corpus.tsv`` (``token<TAB>tag``
  lines, a blank line between sentences); tokens map to embedding rows
  by ``hash_token_ids``;
- tables (TABULAR_*, ref :82-97 and :432-492): a CSV with a header
  row, the label the last column unless named; integral labels make a
  classification set.

The host dataset cache (ref :160-345): the image, token and tabular
loaders go through one process-wide byte-budget LRU keyed by the file's
``(abspath, mtime_ns, size)`` fingerprint (and, for tables, the label
column), with the budget ``RAFIKI_TPU_DATASET_CACHE_BYTES`` read per
call (0 disables it). So trials 2..N of a sub-train job parse nothing.
A cached dataset is shared by every caller: its arrays are read-only,
and a write to them raises. The corpus loader is not cached, as in the
reference. Hits, misses, evictions and the bytes held go to
``observe.phases``' ``dataset`` family. ``ByteBudgetLRU`` is also the
device staging cache's store (``torch_model.py``), and ``stage_owner``
marks the entries a sub-train job makes in either cache as its own.
"""

from __future__ import annotations

import csv
import io
import os
import threading
import zipfile
from collections import OrderedDict
from dataclasses import dataclass
from typing import (Any, Callable, Dict, Iterator, List, Optional,
                    Sequence, Tuple)

import numpy as np

from ..observe import phases as _phases


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

    def normalized(self, dtype=np.float32) -> np.ndarray:
        """Images scaled to [0, 1] (ref :65-67)."""
        return self.images.astype(dtype) / 255.0

    def batches(self, batch_size: int, *, shuffle: bool = False,
                seed: int = 0, drop_remainder: bool = False,
                ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """``(images, labels)`` batches in order, or shuffled by
        ``default_rng(seed)`` (ref :69-80)."""
        idx = np.arange(self.size)
        if shuffle:
            np.random.default_rng(seed).shuffle(idx)
        stop = ((self.size // batch_size) * batch_size if drop_remainder
                else self.size)
        for start in range(0, stop, batch_size):
            sel = idx[start:start + batch_size]
            yield self.images[sel], self.labels[sel]


# --- The host dataset cache (ref :160-345) ---------------------------

DATASET_CACHE_ENV = "RAFIKI_TPU_DATASET_CACHE_BYTES"
DATASET_CACHE_DEFAULT = 1 << 30  # keep NodeConfig.dataset_cache_bytes equal

# The residency caches are process-wide, but their entries belong to a
# job: the TrialRunner binds its sub-train job's id around train and
# evaluate, and an eviction that entry's insert causes takes the other
# jobs' entries first. Callers that bind none keep plain LRU order.
_owner_local = threading.local()


class stage_owner:
    """``with stage_owner(sub_train_job_id): ...`` marks the cache
    entries this thread makes as that job's, and makes the evictions
    they cause take other owners' entries first."""

    def __init__(self, owner: Optional[str]):
        self._owner = owner

    def __enter__(self):
        self._prior = getattr(_owner_local, "owner", None)
        _owner_local.owner = self._owner
        return self

    def __exit__(self, *exc):
        _owner_local.owner = self._prior
        return False


def current_stage_owner() -> Optional[str]:
    return getattr(_owner_local, "owner", None)


class ByteBudgetLRU:
    """The byte-budget LRU of both residency caches, the host dataset
    cache here and the device staging cache in ``torch_model``.
    ``metrics_name`` is the ``observe.phases`` cache family its evict
    counter and bytes gauge report under."""

    def __init__(self, metrics_name: str):
        self._name = metrics_name
        self._lock = threading.Lock()
        #: key -> (value, nbytes, owner)
        self._entries: "OrderedDict[Any, Tuple[Any, int, Optional[str]]]" \
            = OrderedDict()
        self._bytes = 0

    def get(self, key: Any) -> Optional[Any]:
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                return None
            self._entries.move_to_end(key)
            return entry[0]

    def put(self, key: Any, value: Any, nbytes: int,
            budget: int) -> None:
        if nbytes > budget:
            return  # it would evict everything and still not fit
        owner = current_stage_owner()
        n_evicted = 0
        with self._lock:
            prev = self._entries.pop(key, None)
            if prev is not None:
                self._bytes -= prev[1]
            self._entries[key] = (value, nbytes, owner)
            self._bytes += nbytes
            while self._bytes > budget and len(self._entries) > 1:
                # The oldest entry of another owner goes first (an
                # unowned entry is another owner's to an owned insert,
                # and the other way round); then plain LRU order.
                victim = None
                for k, (_, _, ent_owner) in self._entries.items():
                    if k != key and ent_owner != owner:
                        victim = k
                        break
                if victim is None:
                    victim = next(k for k in self._entries if k != key)
                _, ev_bytes, _ = self._entries.pop(victim)
                self._bytes -= ev_bytes
                n_evicted += 1
            held = self._bytes
        if n_evicted:
            _phases.cache_event(self._name, "evict", n_evicted)
        _phases.set_cache_bytes(self._name, held)

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._bytes = 0
        _phases.set_cache_bytes(self._name, 0)

    def info(self) -> Dict[str, int]:
        with self._lock:
            return {"entries": len(self._entries), "bytes": self._bytes}


_DATASET_CACHE = ByteBudgetLRU("dataset")


def env_bytes(name: str, default: int) -> int:
    """A byte count from the environment variable ``name``, read per
    call, so a test or ``NodeConfig.apply_env`` takes effect at once. A
    value that is not an integer reads as ``default`` (``NodeConfig``'s
    ``validate`` is where it is refused)."""
    try:
        return int(os.environ.get(name, default))
    except ValueError:
        return default


def dataset_cache_budget() -> int:
    """The host dataset cache's byte budget (0 disables it)."""
    return env_bytes(DATASET_CACHE_ENV, DATASET_CACHE_DEFAULT)


def dataset_fingerprint(dataset_path: str) -> Tuple[str, int, int]:
    """The identity of a dataset file, ``(abspath, mtime_ns, size)``:
    the key of both caches, so a rewritten file is a new dataset in
    each. Loaders stamp the fingerprint they read under on the dataset
    (``ds.fingerprint``), and the staging cache keys by that, not by a
    fresh stat, which could file old data under a rewritten file's
    identity."""
    st = os.stat(dataset_path)
    return (os.path.abspath(dataset_path), st.st_mtime_ns, st.st_size)


def clear_dataset_cache() -> None:
    _DATASET_CACHE.clear()


def _freeze(ds: Any) -> None:
    """Make a to-be-cached dataset's arrays read-only: the object is
    shared by the whole process, and a write to it would change every
    later trial's data under an unchanged fingerprint. Frozen, the
    write raises where it is made."""
    for name in ("images", "labels", "features", "targets", "ids"):
        arr = getattr(ds, name, None)
        if isinstance(arr, np.ndarray):
            arr.setflags(write=False)


def _cached_load(kind: str, dataset_path: str,
                 parse: Callable[[], Any]) -> Any:
    if not os.path.exists(dataset_path):
        raise FileNotFoundError(dataset_path)
    fp = dataset_fingerprint(dataset_path)
    if dataset_cache_budget() <= 0:
        ds = parse()
        ds.fingerprint = fp
        return ds
    key = (kind, *fp)
    ds = _DATASET_CACHE.get(key)
    if ds is not None:
        _phases.cache_event("dataset", "hit")
        return ds
    _phases.cache_event("dataset", "miss")
    ds = parse()
    ds.fingerprint = fp
    _freeze(ds)
    _DATASET_CACHE.put(key, ds, _dataset_nbytes(ds),
                       dataset_cache_budget())
    return ds


def _dataset_nbytes(ds: Any) -> int:
    if isinstance(ds, ImageDataset):
        return int(ds.images.nbytes + ds.labels.nbytes)
    if isinstance(ds, TokenDataset):
        return int(ds.ids.nbytes)
    if isinstance(ds, TabularDataset):
        return int(ds.features.nbytes + ds.targets.nbytes)
    return 0


# --- Images ----------------------------------------------------------

def load_image_dataset(dataset_path: str) -> ImageDataset:
    """Load an image-classification dataset, packed ``.npz`` or a zip
    of PNG files (ref ``model/dataset.py:350-366``), through the host
    cache: repeat loads of an unchanged file return the same read-only
    object."""

    def parse() -> ImageDataset:
        if dataset_path.endswith(".npz"):
            return _load_image_npz(dataset_path)
        if zipfile.is_zipfile(dataset_path):
            return _load_image_zip(dataset_path)
        raise ValueError(f"Unrecognised dataset format: {dataset_path}")

    return _cached_load("image", dataset_path, parse)


#: The reference's name (upstream ``dataset_utils``).
load_dataset_of_image_files = load_image_dataset


def _load_image_npz(path: str) -> ImageDataset:
    with np.load(path) as z:
        images = np.asarray(z["images"], dtype=np.uint8)
        labels = np.asarray(z["labels"], dtype=np.int64)
        n_classes = (int(z["n_classes"]) if "n_classes" in z
                     else int(labels.max()) + 1)
    if images.ndim == 3:  # grayscale without channel dim
        images = images[..., None]
    return ImageDataset(images=images, labels=labels, n_classes=n_classes)


def _load_image_zip(path: str) -> ImageDataset:
    from PIL import Image

    with zipfile.ZipFile(path) as zf:
        with zf.open("images.csv") as f:
            rows = list(csv.DictReader(io.TextIOWrapper(f, "utf-8")))
        imgs, labels = [], []
        for row in rows:
            with zf.open(row["path"]) as imf:
                arr = np.asarray(Image.open(imf))
            if arr.ndim == 2:
                arr = arr[..., None]
            imgs.append(arr.astype(np.uint8))
            labels.append(int(row["class"]))
    images = np.stack(imgs)
    labels_arr = np.asarray(labels, dtype=np.int64)
    return ImageDataset(images=images, labels=labels_arr,
                        n_classes=int(labels_arr.max()) + 1)


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


def write_image_files_dataset(images: np.ndarray, labels: np.ndarray,
                              out_path: str) -> str:
    """Write the reference-compatible zip of PNGs (ref :508-530):
    ``images/<i>.png`` and the ``images.csv`` index."""
    from PIL import Image

    images = np.asarray(images, dtype=np.uint8)
    if images.ndim == 3:
        images = images[..., None]
    labels = np.asarray(labels, dtype=np.int64)
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with zipfile.ZipFile(out_path, "w", zipfile.ZIP_DEFLATED) as zf:
        index = io.StringIO()
        w = csv.writer(index)
        w.writerow(["path", "class"])
        for i, (img, lab) in enumerate(zip(images, labels)):
            name = f"images/{i}.png"
            buf = io.BytesIO()
            arr = img[..., 0] if img.shape[-1] == 1 else img
            Image.fromarray(arr).save(buf, format="PNG")
            zf.writestr(name, buf.getvalue())
            w.writerow([name, int(lab)])
        zf.writestr("images.csv", index.getvalue())
    return out_path


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
    ``vocab_size``), through the host cache."""

    def parse() -> TokenDataset:
        with np.load(dataset_path) as z:
            ids = np.asarray(z["ids"], dtype=np.int32)
            vocab_size = int(z["vocab_size"])
        if ids.ndim != 1:
            raise ValueError(f"token dataset must be 1-D, got {ids.shape}")
        if ids.size and (ids.min() < 0 or ids.max() >= vocab_size):
            raise ValueError("token ids out of range for vocab_size "
                             f"{vocab_size}")
        return TokenDataset(ids=ids, vocab_size=vocab_size)

    return _cached_load("token", dataset_path, parse)


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


load_dataset_of_corpus = load_corpus_dataset


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
    :432-476); ``label_col`` defaults to the last column. Cached, keyed
    by ``label_col`` too: one file cut around another target column is
    another dataset."""

    def parse() -> TabularDataset:
        with open(dataset_path, newline="", encoding="utf-8") as f:
            rows = list(csv.reader(f))
        if len(rows) < 2:
            raise ValueError(
                f"tabular dataset {dataset_path} has no data rows")
        header, data = rows[0], rows[1:]
        if label_col is None:
            label_idx = len(header) - 1
        else:
            if label_col not in header:
                raise ValueError(
                    f"label column {label_col!r} not in {header}")
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
                              target_name=header[label_idx],
                              n_classes=n_classes)

    return _cached_load(f"tabular:{label_col}", dataset_path, parse)


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
