"""The flagship LM on a group of 4 CPU entries against the reference on
4 of its 8 virtual CPU devices, from the same parameters: one step's
loss and gradients, a short train's losses and parameters, then evaluate
and predict (the tables and the BiLSTM in
``tests/test_torch_dp_families.py``).

d_model 128, 2 layers, seq_len 64, vocabulary 128, batch 8: 2 windows a
rank, each rank's forward and backward on its own windows. Both compute
in bf16 with the plain attention on the CPU, so the tolerances are
``test_torch_lm_train.py``'s: one step's loss within 1e-3 and each
gradient within 3e-2 (relative Frobenius), the ranks' gradients summed
in each weight's ``.grad``; after 4 AdamW steps the chunk losses within
2e-3 and each update within 5e-2 (relative Frobenius) and 1e-2 an entry;
the evaluation's accuracy within 4/4096 and each query's score within
1e-2.
"""

import _torch_threads  # noqa: F401  (caps torch threads under xdist)

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_dp import bound
from rafiki_torch.datasets import make_synthetic_token_dataset
from rafiki_torch.model.bridge import lm_to_jax
from rafiki_torch.model.logger import logger as torch_logger
from rafiki_torch.models import TorchTransformerLM
from rafiki_tpu.model.logger import logger as jax_logger
from rafiki_tpu.models import JaxTransformerLM

LM = {"d_model": 128, "n_layers": 2, "seq_len": 64, "vocab_size": 128,
      "batch_size": 8, "train_steps": 4, "steps_per_dispatch": 2,
      "learning_rate": 1e-3, "remat": "none", "quick_train": False}


@pytest.fixture(scope="module")
def lm_setup(tmp_path_factory):
    tm = TorchTransformerLM(device="cpu", **LM)
    tm._install(tm._init_params())
    data = make_synthetic_token_dataset(
        str(tmp_path_factory.mktemp("dp_lm")), n_train=1 << 13,
        n_val=1 << 11, vocab_size=128, branching=2)
    return tm.dump_parameters(), data


def test_lm_one_step_gradients(lm_setup):
    p, _ = lm_setup
    win = np.random.default_rng(5).integers(0, 128, (8, 65))
    jm = JaxTransformerLM(**LM)
    jm.load_parameters(p)

    def loss_fn(params):
        logits = jm._forward(params, jnp.asarray(win[:, :-1], jnp.int32))
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.asarray(win[:, 1:])).mean()

    jloss, jgrads = jax.value_and_grad(loss_fn)(jm._params)
    jgrads = {"embed": jgrads["embed"], "lnf": jgrads["lnf"],
              **{f"layers/{k}": v for k, v in jgrads["layers"].items()}}
    with bound():
        tm = TorchTransformerLM(device="cpu", **LM)
        tm.load_parameters(p)
        assert tm.mesh.shape["dp"] == 4
        loss, _ = tm._mesh_loss(torch.from_numpy(win))
        loss.backward()
    tgrads = lm_to_jax({k: w.grad for k, w in tm._net.named_parameters()})
    assert abs(float(loss.detach()) - float(jloss)) <= 1e-3
    for k, g in jgrads.items():
        g = np.asarray(g)
        assert np.linalg.norm(tgrads[k] - g) <= 3e-2 * np.linalg.norm(g), k


def test_lm_train_evaluate_and_predict(lm_setup):
    p, (train_path, val_path) = lm_setup
    with bound():
        jm = JaxTransformerLM(**LM)
        jm.load_parameters(p)
        jrec = []
        prior = jax_logger.current_sink()
        jax_logger.set_sink(jrec.append)
        try:
            jm.train(train_path)
        finally:
            jax_logger.set_sink(prior)
        tm = TorchTransformerLM(device="cpu", **LM)
        tm.load_parameters(p)
        trec = []
        prior = torch_logger.current_sink()
        torch_logger.set_sink(trec.append)
        try:
            tm.train(train_path)
        finally:
            torch_logger.set_sink(prior)
        jp, tp = jm.dump_parameters(), tm.dump_parameters()
        jrec = [r["values"] for r in jrec if r.get("type") == "values"]
        trec = [r["values"] for r in trec if r.get("type") == "values"]
        assert [r["step"] for r in trec] == [r["step"] for r in jrec] == [
            2, 4]
        for j, t in zip(jrec, trec):
            assert abs(t["loss"] - j["loss"]) <= 2e-3, (t, j)
        for k in p:
            ju, tu = np.asarray(jp[k]) - p[k], tp[k] - p[k]
            assert np.linalg.norm(tu - ju) <= 5e-2 * np.linalg.norm(ju), k
            np.testing.assert_allclose(tp[k], np.asarray(jp[k]), atol=1e-2,
                                       rtol=0)
        # Evaluate and predict on the same (the reference's) weights.
        tm.load_parameters({k: np.asarray(v) for k, v in jp.items()})
        assert abs(tm.evaluate(val_path) - jm.evaluate(val_path)) <= 4 / 4096
        queries = [list(range(1, 20)), [5, 7, 9], list(range(40, 105))]
        np.testing.assert_allclose(tm.predict(queries), jm.predict(queries),
                                   atol=1e-2, rtol=0)
