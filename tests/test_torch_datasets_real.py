"""The port's converters of real data and the taggers on the bundled
English corpus, against the JAX package on the CPU.

The converters must give what the reference's give, byte for byte or
array for array: fashion-MNIST's IDX files (plain and gzipped, a bad
magic the same error), CIFAR-10's pickle batches, the bundled corpus's
split zips, and sklearn's tables. On the corpus's val split both taggers
run from the same bridged weights: the transformer's bf16 logits within
``tests/test_torch_tagger.py``'s 2^-5 and, in f32, within 1e-4 with each
package's ``evaluate`` giving the same accuracy; the BiLSTM's f32
logits within ``tests/test_torch_tabular_pos.py``'s 1e-5 and the same
accuracy.
"""

import _torch_threads  # noqa: F401  (caps torch threads under xdist)
import gzip
import json
import os
import pickle
import struct
import subprocess
import sys
import zipfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from rafiki_torch import datasets as pdata
from rafiki_torch.datasets import prep as pprep
from rafiki_torch.model.bridge import dense_from_jax
from rafiki_torch.model.dataset import load_corpus_dataset
from rafiki_torch.models import (TorchPosTagger, TorchTransformerTagger,
                                 layers)
from rafiki_torch.models import pos_tagger as tp
from rafiki_torch.models import transformer as tt
from rafiki_torch.ops import default_attention
from rafiki_tpu import datasets as rdata
from rafiki_tpu.models.pos_tagger import JaxPosTagger, _BiLstm
from rafiki_tpu.models.transformer import (JaxTransformerTagger,
                                           _TransformerTagger)
from rafiki_tpu.ops import default_attention as jax_attention

ROOT = Path(__file__).resolve().parents[1]


def _npz(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _same_npz(a, b):
    za, zb = _npz(a), _npz(b)
    assert set(za) == set(zb)
    for k in za:
        assert za[k].dtype == zb[k].dtype and np.array_equal(za[k], zb[k])


def _idx(path, magic, arr, header, gz):
    raw = struct.pack(">" + "I" * (1 + len(header)), magic, *header) \
        + arr.tobytes()
    if gz:
        path += ".gz"
        with gzip.open(path, "wb") as f:
            f.write(raw)
    else:
        with open(path, "wb") as f:
            f.write(raw)


def _fashion(raw, gz, bad=None):
    rng = np.random.default_rng(0)
    os.makedirs(raw, exist_ok=True)
    for split, n in (("train", 20), ("t10k", 8)):
        imgs = rng.integers(0, 256, (n, 5, 4)).astype(np.uint8)
        labels = rng.integers(0, 10, n).astype(np.uint8)
        _idx(os.path.join(raw, f"{split}-images-idx3-ubyte"),
             0x803 if bad != "images" else 0x804, imgs, (n, 5, 4), gz)
        _idx(os.path.join(raw, f"{split}-labels-idx1-ubyte"),
             0x801 if bad != "labels" else 0x800, labels, (n,), gz)


@pytest.mark.parametrize("gz", [False, True])
@pytest.mark.parametrize("val_frac", [0.0, 0.25])
def test_fashion_mnist_converts_as_the_reference(tmp_path, gz, val_frac):
    raw = str(tmp_path / "raw")
    _fashion(raw, gz)
    got = pdata.prepare_fashion_mnist(raw, str(tmp_path / "p"), val_frac)
    want = rdata.prepare_fashion_mnist(raw, str(tmp_path / "r"), val_frac)
    assert [os.path.basename(p) for p in got] == \
        [os.path.basename(p) for p in want]
    for a, b in zip(got, want):
        _same_npz(a, b)
    assert _npz(got[0])["images"].shape == \
        ((15 if val_frac else 20), 5, 4, 1)


@pytest.mark.parametrize("bad", ["images", "labels", "missing"])
def test_fashion_mnist_refuses_as_the_reference(tmp_path, bad):
    raw = str(tmp_path / "raw")
    _fashion(raw, False, bad)
    if bad == "missing":
        os.remove(os.path.join(raw, "t10k-labels-idx1-ubyte"))
    errs = []
    for mod in (pdata, rdata):
        with pytest.raises((ValueError, FileNotFoundError)) as e:
            mod.prepare_fashion_mnist(raw, str(tmp_path / "o"))
        errs.append((type(e.value), str(e.value)))
    assert errs[0] == errs[1]
    assert "magic" in errs[0][1] or "missing" in errs[0][1]


@pytest.mark.parametrize("nested", [False, True])
def test_cifar10_converts_as_the_reference(tmp_path, nested):
    raw = tmp_path / "raw"
    batches = raw / "cifar-10-batches-py" if nested else raw
    batches.mkdir(parents=True)
    rng = np.random.default_rng(1)
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        n = 3
        with open(batches / name, "wb") as f:
            pickle.dump({b"data": rng.integers(0, 256, (n, 3072)).astype(
                             np.uint8),
                         b"labels": rng.integers(0, 10, n).tolist()}, f)
    got = pdata.prepare_cifar10(str(raw), str(tmp_path / "p"))
    want = rdata.prepare_cifar10(str(raw), str(tmp_path / "r"))
    for a, b in zip(got, want):
        _same_npz(a, b)
    assert _npz(got[0])["images"].shape == (15, 32, 32, 3)
    os.remove(batches / "test_batch")
    errs = []
    for mod in (pdata, rdata):
        with pytest.raises(FileNotFoundError) as e:
            mod.prepare_cifar10(str(raw), str(tmp_path / "o"))
        errs.append(str(e.value))
    assert errs[0] == errs[1]


def test_the_prep_cli_writes_what_the_function_does(tmp_path):
    raw = str(tmp_path / "raw")
    _fashion(raw, True)
    out = subprocess.run(
        [sys.executable, "-m", "rafiki_torch.datasets.prep",
         "fashion_mnist", "--raw-dir", raw, "--out-dir",
         str(tmp_path / "cli")], cwd=ROOT, capture_output=True, text=True,
        timeout=120)
    assert out.returncode == 0, out.stderr
    direct = pprep.prepare_fashion_mnist(raw, str(tmp_path / "direct"))
    for name, path in zip(("train", "val"), direct):
        _same_npz(str(tmp_path / "cli" / os.path.basename(path)), path)
        assert f"{name}:" in out.stdout


@pytest.mark.parametrize("seed", [0, 1])
def test_the_bundled_corpus_splits_byte_for_byte(tmp_path, seed):
    got = pdata.prepare_bundled_pos_corpus(str(tmp_path / "p"), seed=seed)
    want = rdata.prepare_bundled_pos_corpus(str(tmp_path / "r"), seed=seed)
    assert [os.path.basename(p) for p in got] == ["pos_train.zip",
                                                  "pos_val.zip"]
    for a, b in zip(got, want):
        with zipfile.ZipFile(a) as za, zipfile.ZipFile(b) as zb:
            for name in ("tags.txt", "corpus.tsv"):
                assert za.read(name) == zb.read(name), name
    assert pdata.BUNDLED_POS_CORPUS.endswith(
        os.path.join("examples", "datasets", "english_pos", "corpus.tsv"))
    train, val = (load_corpus_dataset(p) for p in got)
    assert train.size + val.size == 679 and val.size == 135
    assert len(train.tag_names) == 11 and train.tag_names == val.tag_names


@pytest.mark.parametrize("name", ["breast_cancer", "wine", "diabetes"])
def test_sklearn_tables_are_byte_for_byte_the_reference(tmp_path, name):
    pytest.importorskip("sklearn")
    got = pdata.prepare_sklearn_tabular(name, str(tmp_path / "p"))
    want = rdata.prepare_sklearn_tabular(name, str(tmp_path / "r"))
    for a, b in zip(got, want):
        assert os.path.basename(a) == os.path.basename(b)
        assert Path(a).read_bytes() == Path(b).read_bytes()


def test_sklearn_digits_are_the_reference(tmp_path):
    pytest.importorskip("sklearn")
    got = pdata.prepare_sklearn_digits(str(tmp_path / "p"))
    want = rdata.prepare_sklearn_digits(str(tmp_path / "r"))
    for a, b in zip(got, want):
        _same_npz(a, b)


# --- The taggers on the bundled corpus's val split ---

T_KNOBS = {"d_model": 64, "n_heads": 2, "n_layers": 2, "max_len": 64,
           "vocab_size": 2048, "dropout": 0.0}
B_KNOBS = {"embed_dim": 16, "hidden": 12, "vocab_size": 2048,
           "max_len": 64}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return pdata.prepare_bundled_pos_corpus(
        str(tmp_path_factory.mktemp("pos")))


def _flat(variables):
    return {k: np.asarray(v) for k, v in
            traverse_util.flatten_dict(variables, sep="/").items()}


def _unflat(flat):
    return {"params": traverse_util.unflatten_dict(
        {k[len("params/"):]: jnp.asarray(v) for k, v in flat.items()},
        sep="/")}


def _jittered(flat, suffixes, seed=0):
    rng = np.random.default_rng(seed)
    for k, v in flat.items():
        if k.endswith(suffixes):
            flat[k] = (v + 0.1 * rng.standard_normal(v.shape)).astype(
                np.float32)
    return flat


def _with_tags(flat, tag_names):
    p = dict(flat)
    p["_meta/tag_names_json"] = np.frombuffer(
        json.dumps(tag_names).encode(), np.uint8)
    return p


class _JaxTagger32(JaxTransformerTagger):
    def _ensure_module(self, n_tags):
        if self._module is None:
            super()._ensure_module(n_tags)
            self._module = self._module.clone(dtype=jnp.float32)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_the_transformer_tagger_on_the_val_split(corpus, dtype,
                                                 monkeypatch):
    """bf16, the tagger's dtype: logits within 2^-5 (random weights
    leave near-ties, so argmax may flip on a few of the split's tokens).
    f32
    (flax's ``dtype`` and the port's ``layers.COMPUTE``): logits within
    1e-4 and ``evaluate`` the same accuracy."""
    f32 = dtype == "float32"
    if f32:
        monkeypatch.setattr(layers, "COMPUTE", torch.float32)
    val = load_corpus_dataset(corpus[1])
    n_tags = len(val.tag_names)
    tm = TorchTransformerTagger(device="cpu", **T_KNOBS)
    ids, _ = tm._encode(val.sentences)
    module = _TransformerTagger(vocab_size=2048, d_model=64, n_heads=2,
                                n_layers=2, n_tags=n_tags, max_len=64,
                                dtype=getattr(jnp, dtype))
    flat = _jittered(_flat(module.init(
        jax.random.key(0), jnp.asarray(ids[:4]),
        jax_attention(causal=False))), ("/scale", "/bias"))
    want = np.asarray(module.apply(_unflat(flat), jnp.asarray(ids),
                                   jax_attention(causal=False)))
    net = tt._TransformerTagger(2048, 64, 2, 2, n_tags, 64, 0.0, seed=0)
    net.load_state_dict(dense_from_jax(flat))
    got = net(torch.from_numpy(ids), default_attention(causal=False))
    np.testing.assert_allclose(got.detach().numpy(), want,
                               atol=1e-4 if f32 else 2 ** -5, rtol=0)
    if f32:
        p = _with_tags(flat, val.tag_names)
        jm = _JaxTagger32(**T_KNOBS)
        jm.load_parameters(p)
        tm.load_parameters(p)
        assert tm.evaluate(corpus[1]) == jm.evaluate(corpus[1])


def test_the_bilstm_tagger_on_the_val_split(corpus):
    val = load_corpus_dataset(corpus[1])
    n_tags = len(val.tag_names)
    tm = TorchPosTagger(device="cpu", **B_KNOBS)
    ids, lengths = tm._encode(val.sentences)
    module = _BiLstm(vocab_size=2048, embed_dim=16, hidden=12,
                     n_tags=n_tags)
    flat = _jittered(_flat(module.init(
        jax.random.key(1), jnp.asarray(ids[:4]),
        jnp.asarray(lengths[:4]))), ("/bias",))
    want = np.asarray(module.apply(_unflat(flat), jnp.asarray(ids),
                                   jnp.asarray(lengths)))
    net = tp._BiLstm(2048, 16, 12, n_tags, seed=0)
    net.load_state_dict(dense_from_jax(flat))
    got = net(torch.from_numpy(ids), torch.from_numpy(lengths))
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5,
                               rtol=0)
    p = _with_tags(flat, val.tag_names)
    jm = JaxPosTagger(**B_KNOBS)
    jm.load_parameters(p)
    tm.load_parameters(p)
    assert tm.evaluate(corpus[1]) == jm.evaluate(corpus[1])
