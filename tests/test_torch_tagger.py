"""``TorchTransformerTagger`` against ``JaxTransformerTagger`` on the CPU.

Weights come from the JAX side through the bridge, the norms jittered.
Size: 2 layers, d_model 64, 2 heads of 32, max_len 32, a vocabulary of
500, dropout 0. Both sides attend with ``default_attention``, the
blockwise formulation on the CPU, with ``kv_mask = ids != PAD_ID``.
Only real rows are compared: the predict path pads a batch with
all-``PAD_ID`` rows, whose every key is masked; K1 and the blockwise
formulation differ there by design, and the rows are sliced off.

Tolerances. bf16 (the tagger's dtype): logits within 2^-5, two bf16
ulps of a logit below 4 (measured 2.2e-2 at the jittered norms), and
probabilities within 1e-2. One train step runs in float32 (flax's
``dtype`` and the port's ``layers.COMPUTE``): two AdamW steps under the
warm-up cosine, the losses within 1e-5 and each tensor's update within
1e-3 of its size.
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

from rafiki_torch.datasets import make_synthetic_corpus_dataset
from rafiki_torch.model.bridge import dense_from_jax, dense_to_jax
from rafiki_torch.model.logger import logger as torch_logger
from rafiki_torch.models import TorchTransformerTagger, layers
from rafiki_torch.models import transformer as tt
from rafiki_torch.ops import default_attention
from rafiki_tpu.model.logger import logger as jax_logger
from rafiki_tpu.models.transformer import (JaxTransformerTagger,
                                           _TransformerTagger)
from rafiki_tpu.ops import default_attention as jax_attention

KNOBS = {"d_model": 64, "n_heads": 2, "n_layers": 2, "max_len": 32,
         "vocab_size": 500, "dropout": 0.0}
N_TAGS = 5
LENGTHS = np.array([32, 5, 17, 1, 30, 20])


def _flat(variables):
    return {k: np.asarray(v) for k, v in
            traverse_util.flatten_dict(variables, sep="/").items()}


def _unflat(flat):
    return {"params": traverse_util.unflatten_dict(
        {k[len("params/"):]: jnp.asarray(v) for k, v in flat.items()},
        sep="/")}


def _ids(seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, 500, (len(LENGTHS), 32))
    ids[np.arange(32)[None, :] >= LENGTHS[:, None]] = 0
    return ids


def _jax_module(dtype=jnp.bfloat16):
    return _TransformerTagger(vocab_size=500, d_model=64, n_heads=2,
                              n_layers=2, n_tags=N_TAGS, max_len=32,
                              dtype=dtype)


@functools.lru_cache(maxsize=None)
def _init(seed=0):
    flat = _flat(_jax_module().init(jax.random.key(seed),
                                    jnp.asarray(_ids()),
                                    jax_attention(causal=False)))
    rng = np.random.default_rng(seed)
    for k, v in flat.items():
        if k.endswith(("/scale", "/bias")):
            flat[k] = (v + 0.1 * rng.standard_normal(v.shape)).astype(
                np.float32)
    return flat


def _port(flat):
    net = tt._TransformerTagger(500, 64, 2, 2, N_TAGS, 32, 0.0, seed=0)
    net.load_state_dict(dense_from_jax(flat))
    return net


def test_forward_with_padded_sentences_matches_jax():
    flat = _init()
    ids = _ids()
    want = np.asarray(_jax_module().apply(
        _unflat(flat), jnp.asarray(ids), jax_attention(causal=False)))
    got = _port(flat)(torch.from_numpy(ids), default_attention(causal=False))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), want, atol=2 ** -5,
                               rtol=0)


def test_the_bridge_round_trip_is_exact():
    flat = _init()
    back = dense_to_jax(_port(flat).state_dict())
    assert set(back) == set(flat)
    assert "params/Embed_0/embedding" in back
    for k in flat:
        assert np.array_equal(back[k], flat[k]), k


def _train(logger, model, path, shared):
    recs = []
    prior = logger.current_sink()
    logger.set_sink(recs.append)
    try:
        model.train(path, shared_params=shared)
    finally:
        logger.set_sink(prior)
    return [r["values"] for r in recs
            if r["type"] == "values" and "epoch" in r.get("values", {})]


class _JaxTagger32(JaxTransformerTagger):
    def _ensure_module(self, n_tags):
        if self._module is None:
            super()._ensure_module(n_tags)
            self._module = self._module.clone(dtype=jnp.float32)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return make_synthetic_corpus_dataset(
        str(tmp_path_factory.mktemp("tag")), n_train=32, n_val=16,
        vocab=200, n_tags=N_TAGS, max_len=30, seed=0)


def test_two_train_steps_match_jax(corpus, monkeypatch):
    """32 sentences at batch 16: two AdamW steps (weight decay 1e-3)
    under the warm-up cosine, from the same parameters, in f32."""
    monkeypatch.setattr(layers, "COMPUTE", torch.float32)
    start = _init(1)
    knobs = dict(KNOBS, learning_rate=3e-3, batch_size=16, max_epochs=1)
    jm = _JaxTagger32(**knobs)
    tm = TorchTransformerTagger(device="cpu", **knobs)
    jrec = _train(jax_logger, jm, corpus[0], start)
    trec = _train(torch_logger, tm, corpus[0], start)
    assert len(jrec) == len(trec) == 1
    assert abs(jrec[0]["loss"] - trec[0]["loss"]) <= 1e-5
    assert abs(jrec[0]["token_acc"] - trec[0]["token_acc"]) <= 1e-6
    a = {k: np.asarray(v) for k, v in jm.dump_parameters().items()
         if not k.startswith("_meta/")}
    b = {k: v for k, v in tm.dump_parameters().items()
         if not k.startswith("_meta/")}
    assert set(a) == set(b) == set(start)
    for k in start:
        step = np.linalg.norm(a[k] - start[k])
        assert step > 0, k
        assert np.linalg.norm(b[k] - a[k]) <= 1e-3 * step, k


def _pair():
    p = dict(_init(2))
    p["_meta/tag_names_json"] = np.frombuffer(
        json.dumps([f"TAG{i}" for i in range(N_TAGS)]).encode(), np.uint8)
    jm = JaxTransformerTagger(**KNOBS)
    jm.load_parameters(p)
    tm = TorchTransformerTagger(device="cpu", **KNOBS)
    tm.load_parameters(p)
    return jm, tm, p


def test_predict_lengths_and_distributions_match_jax():
    """Three sentences (a bucket of 4: one all-PAD row sliced off), one
    longer than max_len (cut to it)."""
    jm, tm, _ = _pair()
    rng = np.random.default_rng(3)
    queries = [[f"w{i}" for i in rng.integers(0, 300, n)]
               for n in (7, 40, 1)]
    got, want = tm.predict(queries), jm.predict(queries)
    assert [len(g) for g in got] == [len(w) for w in want] == [7, 32, 1]
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), atol=1e-2,
                                   rtol=0)
        np.testing.assert_allclose(np.asarray(g).sum(-1), 1.0, atol=1e-5)


def test_parameter_files_interchange():
    """The port's file loads into the reference and comes back the
    same, ``_meta/tag_names_json`` untouched."""
    jm, tm, p = _pair()
    out = tm.dump_parameters()
    assert np.array_equal(out["_meta/tag_names_json"],
                          p["_meta/tag_names_json"])
    jm2 = JaxTransformerTagger(**KNOBS)
    jm2.load_parameters(out)
    back = {k: np.asarray(v) for k, v in jm2.dump_parameters().items()}
    assert set(back) == set(out)
    for k in out:
        assert np.array_equal(back[k], np.asarray(out[k])), k


@pytest.mark.parametrize("knob,value", [("sequence_parallel", 2),
                                        ("expert_parallel", 2),
                                        ("pipeline_parallel", 2),
                                        ("moe_experts", 4)])
def test_the_parallel_knobs_raise(knob, value):
    """The parallel knobs are ported: on a mesh of the model's device
    alone, or in a combination the reference refuses, each raises the
    reference's ``ValueError`` where the mesh is built."""
    other, match = {
        "sequence_parallel": ({}, "1 devices not divisible by pp"),
        "expert_parallel": ({}, "needs moe_experts set"),
        "pipeline_parallel": ({"n_layers": 3}, "must divide n_layers"),
        "moe_experts": ({"expert_parallel": 3}, "divisible by it"),
    }[knob]
    m = TorchTransformerTagger(device="cpu", **{knob: value}, **other)
    with pytest.raises(ValueError, match=match):
        m.mesh


def test_hashed_dropout_draws_per_step_and_keeps_the_scale():
    x = torch.ones(64, 128)
    step = torch.zeros((), dtype=torch.int64)
    a = tt.hashed_dropout(x, 0.25, 1, step, 0)
    b = tt.hashed_dropout(x, 0.25, 1, step + 1, 0)
    assert torch.equal(a, tt.hashed_dropout(x, 0.25, 1, step, 0))
    assert not torch.equal(a, b)
    assert abs(float((a == 0).float().mean()) - 0.25) < 0.02
    assert torch.equal(a.unique(), torch.tensor([0.0, 1 / 0.75]))
