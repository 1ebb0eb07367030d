"""A train epoch of two steps of the transformer tagger's parallel modes against the
reference's, and a parameter file of each port mode loaded into the
reference; the dp and sequence-parallel modes.

Both taggers train in float32 (flax's ``dtype``, read as float32 by the
reference's pipeline too, and the port's ``layers.COMPUTE``) on meshes of 4 entries (``_torch_modes.bound``):
16 sentences at batch 8, two AdamW steps under the warm-up cosine from
the same parameters. Tolerances: the losses within 1e-5, each tensor's
update within 1e-3 of its size (as ``test_torch_tagger.py``); the
tags the reference predicts from the port's file, in float32, equal the
port's own.
"""

import _torch_threads  # noqa: F401  (caps torch threads under xdist)

import numpy as np
import pytest
import torch

from _torch_modes import (BASE, MODES, JaxTagger32, bound, f32_pipeline,
                          jax_logger, start_params, torch_logger, train)
from rafiki_torch.datasets import make_synthetic_corpus_dataset
from rafiki_torch.model.dataset import load_corpus_dataset
from rafiki_torch.models import TorchTransformerTagger, layers

STEP = dict(learning_rate=3e-3, batch_size=8, max_epochs=1)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return make_synthetic_corpus_dataset(
        str(tmp_path_factory.mktemp("modes")), n_train=16, n_val=8,
        vocab=100, n_tags=5, max_len=16, seed=0)


def _tags(probs):
    return [np.asarray(p).argmax(-1).tolist() for p in probs]


def one_step_matches(mode, corpus, monkeypatch):
    monkeypatch.setattr(layers, "COMPUTE", torch.float32)
    f32_pipeline(monkeypatch)
    _, start = start_params(mode, seed=1)
    knobs = dict(BASE, **STEP, **MODES[mode])
    with bound():
        jm = JaxTagger32(**knobs)
        tm = TorchTransformerTagger(device="cpu", **knobs)
        jrec = train(jax_logger, jm, corpus[0], shared_params=start)
        trec = train(torch_logger, tm, corpus[0], shared_params=start)
        assert dict(tm.mesh.shape) == dict(jm.mesh.shape)
        assert len(jrec) == len(trec) == 1
        assert abs(jrec[0]["loss"] - trec[0]["loss"]) <= 1e-5
        a = {k: np.asarray(v, np.float32)
             for k, v in jm.dump_parameters().items()
             if not k.startswith("_meta/")}
        out = tm.dump_parameters()
        b = {k: v for k, v in out.items() if not k.startswith("_meta/")}
        assert set(a) == set(b) == set(start)
        for k in start:
            step = np.linalg.norm(a[k] - start[k])
            assert step > 0, k
            assert np.linalg.norm(b[k] - a[k]) <= 1e-3 * step, k
        # The port mode's file, in the reference's same mode.
        jm2 = JaxTagger32(**knobs)
        jm2.load_parameters(out)
        queries = load_corpus_dataset(corpus[1]).sentences[:5]
        assert _tags(jm2.predict(queries)) == _tags(tm.predict(queries))


@pytest.mark.parametrize("mode", ["dp", "sp_ring", "sp_alltoall"])
def test_one_step_and_the_file_match_the_reference(mode, corpus,
                                                   monkeypatch):
    one_step_matches(mode, corpus, monkeypatch)
