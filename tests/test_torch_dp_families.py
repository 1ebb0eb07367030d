"""The tables and the BiLSTM on a group of 4 CPU entries against the
reference on 4 of its 8 virtual CPU devices (the LM in
``tests/test_torch_dp_lm.py``): an epoch's train steps at batch 16, 4
rows a rank, from the same parameters, then predict and evaluate.

Both compute in f32 on both sides (``test_torch_tabular_pos.py``'s
tolerances): the epoch loss within 1e-5, each update within 1e-3 of its
size, probabilities within 1e-4, accuracies within 1e-4 (tables) and
1e-6 (BiLSTM).
"""

import _torch_threads  # noqa: F401  (caps torch threads under xdist)

import jax
import jax.numpy as jnp
import numpy as np

from _torch_dp import bound, train
from rafiki_torch.model.logger import logger as torch_logger
from rafiki_torch.models import TorchPosTagger, TorchTabMlpClf
from rafiki_tpu.model.logger import logger as jax_logger
from rafiki_tpu.models import JaxPosTagger, JaxTabMlpClf
from rafiki_tpu.models.tabular import _Mlp
from test_torch_tabular_pos import (B_KNOBS, TAB_KNOBS, _bilstm_init,
                                    _close_updates, _flat, _start_from)
from test_torch_tabular_pos import corpus, tables  # noqa: F401  (fixtures)


def test_tables(tables):  # noqa: F811  (the fixture)
    train_path, val = tables["clf"]
    start = _flat(jax.jit(_Mlp(hidden=(24, 24), out_dim=3).init)(
        jax.random.key(0), jnp.zeros((1, 6), jnp.float32)))
    with bound():
        jm = JaxTabMlpClf(**TAB_KNOBS)
        jrec = train(jax_logger, jm, train_path)
        tm = TorchTabMlpClf(device="cpu", **TAB_KNOBS)
        _start_from(tm, start)
        trec = train(torch_logger, tm, train_path)
        assert tm.mesh.shape["dp"] == 4
        assert abs(jrec[0]["loss"] - trec[0]["loss"]) <= 1e-5
        a = {k: np.asarray(v) for k, v in jm.dump_parameters().items()
             if not k.startswith("_meta/")}
        b = {k: v for k, v in tm.dump_parameters().items()
             if not k.startswith("_meta/")}
        _close_updates(a, b, start)
        rows = [list(r) for r in
                np.random.default_rng(2).standard_normal((5, 6))]
        np.testing.assert_allclose(np.asarray(tm.predict(rows)),
                                   np.asarray(jm.predict(rows)), atol=1e-4,
                                   rtol=0)
        assert abs(tm.evaluate(val) - jm.evaluate(val)) <= 1e-4


def test_bilstm(corpus):  # noqa: F811  (the fixture)
    _, start = _bilstm_init(1)
    with bound():
        jm = JaxPosTagger(**B_KNOBS)
        tm = TorchPosTagger(device="cpu", **B_KNOBS)
        jrec = train(jax_logger, jm, corpus[0], start)
        trec = train(torch_logger, tm, corpus[0], start)
        assert tm.mesh.shape["dp"] == 4
        assert abs(jrec[0]["loss"] - trec[0]["loss"]) <= 1e-5
        a = {k: np.asarray(v) for k, v in jm.dump_parameters().items()
             if not k.startswith("_meta/")}
        b = {k: v for k, v in tm.dump_parameters().items()
             if not k.startswith("_meta/")}
        _close_updates(a, b, start)
        queries = [["w1", "w2", "w3"], ["w5"] * 30, ["w9"]]
        for g, w in zip(tm.predict(queries), jm.predict(queries)):
            np.testing.assert_allclose(np.asarray(g), np.asarray(w),
                                       atol=1e-4, rtol=0)
        assert abs(tm.evaluate(corpus[1]) - jm.evaluate(corpus[1])) <= 1e-6
