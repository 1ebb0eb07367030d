"""The tabular MLPs and the BiLSTM tagger of the port against the JAX
package on the CPU: ``TorchTabMlpClf``/``TorchTabMlpReg`` against
``JaxTabMlpClf``/``JaxTabMlpReg`` and ``TorchPosTagger`` against
``JaxPosTagger``.

All four compute in f32 on both sides. The reference's tabular train
starts from its own ``jax.random`` initialisation and ignores
``shared_params``, as the port's does; the test draws that same
initialisation and has the port's ``_new_net`` start from it. The JAX
side trains on the 8-device CPU mesh, so train batches are multiples of
8. Tolerances: forwards within 1e-5; after an epoch of Adam steps the
loss within 1e-5 and each tensor's update within 1e-3 of its size;
probabilities within 1e-5. The BiLSTM's backward direction reverses each row within its length (flax's
``flip_sequences``): every position, the padding's too, is held against
the reference.
"""

import _torch_threads  # noqa: F401  (caps torch threads under xdist)
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util
from flax.linen import recurrent

from rafiki_torch.datasets import (make_synthetic_corpus_dataset,
                                   make_synthetic_tabular_dataset)
from rafiki_torch.model import test_model_class
from rafiki_torch.model.bridge import dense_from_jax, dense_to_jax
from rafiki_torch.model.logger import logger as torch_logger
from rafiki_torch.models import (TorchPosTagger, TorchTabMlpClf,
                                 TorchTabMlpReg)
from rafiki_torch.models import pos_tagger as tp
from rafiki_torch.models import tabular as ttab
from rafiki_tpu.model.logger import logger as jax_logger
from rafiki_tpu.models.pos_tagger import JaxPosTagger, _BiLstm
from rafiki_tpu.models.tabular import JaxTabMlpClf, JaxTabMlpReg, _Mlp

ATOL = 1e-5


def _flat(variables):
    return {k: np.asarray(v) for k, v in
            traverse_util.flatten_dict(variables, sep="/").items()}


def _unflat(flat):
    return {"params": traverse_util.unflatten_dict(
        {k[len("params/"):]: jnp.asarray(v) for k, v in flat.items()},
        sep="/")}


def _train(logger, model, path, shared=None):
    recs = []
    prior = logger.current_sink()
    logger.set_sink(recs.append)
    try:
        model.train(path, shared_params=shared)
    finally:
        logger.set_sink(prior)
    return [r["values"] for r in recs
            if r["type"] == "values" and "epoch" in r.get("values", {})]


def _close_updates(a, b, start):
    assert set(a) == set(b)
    for k in start:
        step = np.linalg.norm(a[k] - start[k])
        assert step > 0, k
        assert np.linalg.norm(b[k] - a[k]) <= 1e-3 * step, k


# --- The tabular MLPs ---


@pytest.fixture(scope="module")
def tables(tmp_path_factory):
    root = tmp_path_factory.mktemp("tab")
    return {"clf": make_synthetic_tabular_dataset(
                str(root / "clf"), n_train=64, n_val=32, n_features=6,
                n_classes=3, seed=0),
            "reg": make_synthetic_tabular_dataset(
                str(root / "reg"), n_train=64, n_val=32, n_features=6,
                n_classes=0, seed=1)}


TAB = {"clf": (JaxTabMlpClf, TorchTabMlpClf, 3),
       "reg": (JaxTabMlpReg, TorchTabMlpReg, 1)}
TAB_KNOBS = {"hidden": 24, "depth": 2, "learning_rate": 1e-2,
             "batch_size": 16, "max_epochs": 1, "seed": 0}


def test_mlp_forward_matches_jax():
    jm = _Mlp(hidden=(24, 24), out_dim=3)
    flat = _flat(jm.init(jax.random.key(0), jnp.zeros((1, 6))))
    x = np.random.default_rng(0).standard_normal((5, 6)).astype(np.float32)
    net = ttab._Mlp(6, (24, 24), 3, seed=0)
    net.load_state_dict(dense_from_jax(flat))
    np.testing.assert_allclose(
        net(torch.from_numpy(x)).detach().numpy(),
        np.asarray(jm.apply(_unflat(flat), jnp.asarray(x))), atol=ATOL,
        rtol=0)
    back = dense_to_jax(net.state_dict())
    assert set(back) == set(flat)
    assert all(np.array_equal(back[k], flat[k]) for k in flat)


@pytest.mark.parametrize("kind", ["clf", "reg"])
def test_mlp_training_and_predict_match_jax(tables, kind):
    """One epoch of 4 Adam steps, then predict, evaluate and the
    parameter file."""
    jcls, tcls, out_dim = TAB[kind]
    train, val = tables[kind]
    jm = jcls(**TAB_KNOBS)
    jrec = _train(jax_logger, jm, train)
    start = _flat(jax.jit(_Mlp(hidden=(24, 24), out_dim=out_dim).init)(
        jax.random.key(0), jnp.zeros((1, 6), jnp.float32)))
    tm = tcls(device="cpu", **TAB_KNOBS)
    _start_from(tm, start)
    trec = _train(torch_logger, tm, train)
    assert abs(jrec[0]["loss"] - trec[0]["loss"]) <= ATOL
    a = {k: np.asarray(v) for k, v in jm.dump_parameters().items()
         if not k.startswith("_meta/")}
    b = {k: v for k, v in tm.dump_parameters().items()
         if not k.startswith("_meta/")}
    _close_updates(a, b, start)
    rows = [list(r) for r in np.random.default_rng(2).standard_normal((5, 6))]
    np.testing.assert_allclose(np.asarray(tm.predict(rows)),
                               np.asarray(jm.predict(rows)), atol=1e-4,
                               rtol=0)
    assert abs(tm.evaluate(val) - jm.evaluate(val)) <= 1e-4
    # The reference's file (with its _meta/json) loads into the port.
    tm2 = tcls(device="cpu", **TAB_KNOBS)
    tm2.load_parameters({k: np.asarray(v)
                         for k, v in jm.dump_parameters().items()})
    np.testing.assert_allclose(np.asarray(tm2.predict(rows)),
                               np.asarray(jm.predict(rows)), atol=ATOL,
                               rtol=0)


def _start_from(model, flat):
    """Have ``model``'s train start from the reference's weights ``flat``."""
    new_net = model._new_net

    def started():
        net = new_net()
        net.load_state_dict(dense_from_jax(flat))
        return net

    model._new_net = started


@pytest.mark.parametrize("kind", ["clf", "reg"])
def test_the_mlps_ignore_shared_params(tables, kind):
    """As the reference's train: ``shared_params`` changes nothing."""
    _, tcls, out_dim = TAB[kind]
    train, _ = tables[kind]
    other = _flat(_Mlp(hidden=(24, 24), out_dim=out_dim).init(
        jax.random.key(7), jnp.zeros((1, 6), jnp.float32)))
    plain, shared = (tcls(device="cpu", **TAB_KNOBS) for _ in range(2))
    _train(torch_logger, plain, train)
    _train(torch_logger, shared, train, other)
    a, b = plain.dump_parameters(), shared.dump_parameters()
    assert set(a) == set(b)
    for k in a:
        assert np.array_equal(a[k], b[k]), k


def test_the_classifier_refuses_a_regression_set(tables):
    with pytest.raises(ValueError, match="regression"):
        TorchTabMlpClf(device="cpu", **TAB_KNOBS).train(tables["reg"][0])


# --- The BiLSTM tagger ---

B_KNOBS = {"embed_dim": 16, "hidden": 12, "vocab_size": 500,
           "max_len": 24, "learning_rate": 1e-2, "batch_size": 16,
           "max_epochs": 1, "seed": 0}
LENGTHS = np.array([24, 5, 13, 1, 20, 2])


def _ids(seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, 500, (len(LENGTHS), 24))
    ids[np.arange(24)[None, :] >= LENGTHS[:, None]] = 0
    return ids


@functools.lru_cache(maxsize=None)
def _bilstm_init(seed=0):
    jm = _BiLstm(vocab_size=500, embed_dim=16, hidden=12, n_tags=5)
    flat = _flat(jm.init(jax.random.key(seed), jnp.asarray(_ids()),
                         jnp.asarray(LENGTHS)))
    rng = np.random.default_rng(seed)
    for k, v in flat.items():
        if k.endswith("/bias"):
            flat[k] = (0.1 * rng.standard_normal(v.shape)).astype(np.float32)
    return jm, flat


def test_flip_sequences_is_flaxs():
    x = np.random.default_rng(1).standard_normal((6, 24, 3)).astype(
        np.float32)
    want = np.asarray(recurrent.flip_sequences(
        jnp.asarray(x), jnp.asarray(LENGTHS), num_batch_dims=1,
        time_major=False))
    got = tp.flip_sequences(torch.from_numpy(x), torch.from_numpy(LENGTHS))
    assert np.array_equal(got.numpy(), want)
    assert torch.equal(tp.flip_sequences(got, torch.from_numpy(LENGTHS)),
                       torch.from_numpy(x))


def test_bilstm_forward_matches_jax_at_every_position():
    jm, flat = _bilstm_init()
    ids = _ids()
    want = np.asarray(jm.apply(_unflat(flat), jnp.asarray(ids),
                               jnp.asarray(LENGTHS)))
    net = tp._BiLstm(500, 16, 12, 5, seed=0)
    net.load_state_dict(dense_from_jax(flat))
    got = net(torch.from_numpy(ids), torch.from_numpy(LENGTHS))
    np.testing.assert_allclose(got.detach().numpy(), want, atol=ATOL,
                               rtol=0)
    back = dense_to_jax(net.state_dict())
    assert set(back) == set(flat)
    assert all(np.array_equal(back[k], flat[k]) for k in flat)


def test_the_backward_direction_reverses_within_each_length():
    """Position t of the backward direction sees tokens t .. length − 1
    only: changing a token past the length leaves every real position
    of both directions as it was."""
    _, flat = _bilstm_init()
    net = tp._BiLstm(500, 16, 12, 5, seed=0)
    net.load_state_dict(dense_from_jax(flat))
    ids = _ids()
    other = ids.copy()
    other[1, 10] = 77   # past row 1's length of 5
    a = net(torch.from_numpy(ids), torch.from_numpy(LENGTHS))
    b = net(torch.from_numpy(other), torch.from_numpy(LENGTHS))
    assert torch.equal(a[1, :5], b[1, :5])
    assert not torch.equal(a[1, 5:], b[1, 5:])
    other = ids.copy()
    other[2, 12] = 77   # row 2's last real token
    c = net(torch.from_numpy(other), torch.from_numpy(LENGTHS))
    # The backward half of every earlier position moves.
    assert (c[2, :12] != a[2, :12]).any(-1).all()


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return make_synthetic_corpus_dataset(
        str(tmp_path_factory.mktemp("pos")), n_train=48, n_val=16,
        vocab=200, n_tags=5, max_len=30, seed=0)


def test_bilstm_training_and_predict_match_jax(corpus):
    """One epoch of 3 Adam steps from the same parameters (a warm start
    on both sides), then predict, evaluate and the parameter file."""
    _, start = _bilstm_init(1)
    jm = JaxPosTagger(**B_KNOBS)
    tm = TorchPosTagger(device="cpu", **B_KNOBS)
    jrec = _train(jax_logger, jm, corpus[0], start)
    trec = _train(torch_logger, tm, corpus[0], start)
    assert abs(jrec[0]["loss"] - trec[0]["loss"]) <= ATOL
    a = {k: np.asarray(v) for k, v in jm.dump_parameters().items()
         if not k.startswith("_meta/")}
    b = {k: v for k, v in tm.dump_parameters().items()
         if not k.startswith("_meta/")}
    _close_updates(a, b, start)
    queries = [["w1", "w2", "w3"], ["w5"] * 30, ["w9"]]
    got, want = tm.predict(queries), jm.predict(queries)
    assert [len(g) for g in got] == [len(w) for w in want] == [3, 24, 1]
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), atol=1e-4,
                                   rtol=0)
    assert abs(tm.evaluate(corpus[1]) - jm.evaluate(corpus[1])) <= 1e-6
    p = {k: np.asarray(v) for k, v in jm.dump_parameters().items()}
    tm2 = TorchPosTagger(device="cpu", **B_KNOBS)
    tm2.load_parameters(p)
    out = tm2.dump_parameters()
    assert set(out) == set(p)
    assert all(np.array_equal(np.asarray(out[k]), p[k]) for k in p)
    assert json.loads(out["_meta/tag_names_json"].tobytes()) == [
        f"TAG{i}" for i in range(5)]


@pytest.mark.parametrize("cls,task,data", [
    (TorchTabMlpClf, "TABULAR_CLASSIFICATION", "clf"),
    (TorchTabMlpReg, "TABULAR_REGRESSION", "reg"),
    (TorchPosTagger, "POS_TAGGING", "pos")])
def test_model_class_runs_each(tables, corpus, cls, task, data):
    """The developer's self-check (train, evaluate, the parameter round
    trip, predict) on the CPU."""
    train, val = corpus if data == "pos" else tables[data]
    queries = ([["w1", "w7"], ["w3"]] if data == "pos"
               else [[0.1] * 6, [0.2] * 6])
    knobs = (dict(B_KNOBS, hidden=16, max_epochs=3, max_len=64,
                  vocab_size=16384)
             if data == "pos" else dict(TAB_KNOBS, batch_size=32,
                                        max_epochs=5))
    res = test_model_class(cls, task, train, val, test_queries=queries,
                           knobs=knobs, device="cpu")
    assert len(res.predictions) == 2
    assert res.score > (0.3 if data == "clf" else -1.0)
