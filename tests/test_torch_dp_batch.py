"""The data-parallel batch rule (fault F9): under a group of 4 entries
every family but the transformer tagger trains on the reference's rows.

The reference rounds a trial's batch down to a multiple of its mesh's
``dp``, at least ``dp`` (image zoo ``jax_model.py:486-488``, LM
``lm.py:259-260``, tables ``tabular.py:117-118``, BiLSTM
``pos_tagger.py:122-123``), and starts the image zoo's predict buckets
at ``dp`` (``jax_model.py:1086``). Both packages run under a bound group
of 4: 4 of the reference's 8 virtual CPU devices and 4 CPU entries of
the port. A batch knob of 10 is 8 rows a step there. The rows each step
takes are read on the reference's side from what its train hands
``jax.device_put`` and on the port's from its forward's inputs (or the
image zoo's epoch index tables); they must be equal, array for array
(exact: the same permutations of the same sets). The predict bucket of
1..9 queries must be the reference's.
"""

import _torch_threads  # noqa: F401  (caps torch threads under xdist)

import numpy as np
import pytest
import torch

import rafiki_tpu.model.jax_model as jax_model
import rafiki_tpu.models.lm as jax_lm
import rafiki_tpu.models.pos_tagger as jax_pos
import rafiki_tpu.models.tabular as jax_tab
from _torch_dp import bound, record_puts, train
from rafiki_torch.datasets import (make_synthetic_corpus_dataset,
                                   make_synthetic_image_dataset,
                                   make_synthetic_tabular_dataset,
                                   make_synthetic_token_dataset)
from rafiki_torch.model import torch_model
from rafiki_torch.model.logger import logger as torch_logger
from rafiki_torch.models import (TorchFeedForward, TorchPosTagger,
                                 TorchTabMlpClf, TorchTransformerLM)
from rafiki_torch.models import pos_tagger as tpos
from rafiki_torch.models import tabular as ttab
from rafiki_tpu.model.logger import logger as jax_logger
from rafiki_tpu.models import (JaxFeedForward, JaxPosTagger, JaxTabMlpClf,
                               JaxTransformerLM)

FF = {"hidden_layer_count": 1, "hidden_layer_units": 16,
      "learning_rate": 1e-3, "batch_size": 10, "max_epochs": 1}
LM = {"d_model": 128, "n_layers": 1, "seq_len": 16, "vocab_size": 64,
      "batch_size": 10, "train_steps": 2, "steps_per_dispatch": 2,
      "learning_rate": 1e-3, "remat": "none", "quick_train": False}
TAB = {"hidden": 16, "depth": 1, "learning_rate": 1e-2, "batch_size": 10,
       "max_epochs": 1, "seed": 0}
POS = {"embed_dim": 8, "hidden": 8, "vocab_size": 200, "max_len": 12,
       "learning_rate": 1e-2, "batch_size": 10, "max_epochs": 1, "seed": 0}


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("dp_batch")
    return {
        "image": make_synthetic_image_dataset(
            str(root / "image"), n_train=40, n_val=8, image_shape=(6, 6, 1),
            n_classes=3, seed=0),
        "token": make_synthetic_token_dataset(
            str(root / "token"), n_train=2000, n_val=200, vocab_size=64,
            seed=0),
        "table": make_synthetic_tabular_dataset(
            str(root / "table"), n_train=36, n_val=8, n_features=5,
            n_classes=3, seed=0),
        "corpus": make_synthetic_corpus_dataset(
            str(root / "corpus"), n_train=30, n_val=8, vocab=100,
            n_tags=4, max_len=10, seed=0),
    }


def _port_inputs(monkeypatch, cls, method, arg=0):
    """The list that ``cls.method``'s calls with gradients on fill with
    their ``arg``-th input, as numpy: the rows a train step runs."""
    seen = []
    real = getattr(cls, method)

    def wrapped(self, *args, **kwargs):
        if torch.is_grad_enabled():
            seen.append(args[arg].detach().cpu().numpy().copy())
        return real(self, *args, **kwargs)

    monkeypatch.setattr(cls, method, wrapped)
    return seen


def test_the_image_zoo_trains_on_the_reference_s_rows(data, monkeypatch):
    ref = record_puts(monkeypatch, jax_model)
    seen = []
    real = torch_model._TrainSteps.new_epoch

    def new_epoch(self, order):
        seen.append(np.array(order, copy=True))
        return real(self, order)

    monkeypatch.setattr(torch_model._TrainSteps, "new_epoch", new_epoch)
    with bound():
        jm = JaxFeedForward(**FF)
        train(jax_logger, jm, data["image"][0])
        tm = TorchFeedForward(device="cpu", **FF)
        train(torch_logger, tm, data["image"][0])
        sels = [a for a in ref if a.dtype == np.int32 and a.ndim == 2]
        want = np.concatenate(sels)
        assert want.shape == (5, 8)
        np.testing.assert_array_equal(np.concatenate(seen), want)
        buckets = [jm.predict_bucket(n) for n in range(1, 10)]
        assert buckets == [4, 4, 4, 4, 8, 8, 8, 8, 16]
        assert [tm.predict_bucket(n) for n in range(1, 10)] == buckets


def test_the_lm_trains_on_the_reference_s_rows(data, monkeypatch):
    ref = record_puts(monkeypatch, jax_lm)
    seen = _port_inputs(monkeypatch, TorchTransformerLM, "_logits")
    with bound():
        jm = JaxTransformerLM(**LM)
        jm.train(data["token"][0])
        tm = TorchTransformerLM(device="cpu", **LM)
        tm.train(data["token"][0])
    wins = [a for a in ref if a.ndim == 3]
    want = np.concatenate([w.reshape(-1, w.shape[-1])[:, :-1]
                           for w in wins])
    assert want.shape == (2 * 8, 16)
    np.testing.assert_array_equal(np.concatenate(seen), want)


def test_the_tables_train_on_the_reference_s_rows(data, monkeypatch):
    ref = record_puts(monkeypatch, jax_tab)
    seen = _port_inputs(monkeypatch, ttab._Mlp, "forward")
    with bound():
        train(jax_logger, JaxTabMlpClf(**TAB), data["table"][0])
        train(torch_logger, TorchTabMlpClf(device="cpu", **TAB),
              data["table"][0])
    rows = [a for a in ref if a.ndim == 2 and a.dtype == np.float32]
    want = np.concatenate(rows)
    assert [len(r) for r in rows] == [8] * 4
    np.testing.assert_array_equal(np.concatenate(seen), want)


def test_the_bilstm_trains_on_the_reference_s_rows(data, monkeypatch):
    ref = record_puts(monkeypatch, jax_pos)
    seen = _port_inputs(monkeypatch, tpos._BiLstm, "forward")
    with bound():
        train(jax_logger, JaxPosTagger(**POS), data["corpus"][0])
        tm = TorchPosTagger(device="cpu", **POS)
        train(torch_logger, tm, data["corpus"][0])
    # Each step puts the ids, the lengths and the tags, in that order.
    ids = [a for a in ref if a.ndim == 2 and a.dtype == np.int32][0::2]
    assert [len(a) for a in ids] == [8] * 3
    np.testing.assert_array_equal(np.concatenate(seen),
                                  np.concatenate(ids))
    # Its predict buckets stay powers of two from 1 (ref :250-252).
    assert (tm.batch_multiple(), tm.predict_multiple()) == (4, 1)
