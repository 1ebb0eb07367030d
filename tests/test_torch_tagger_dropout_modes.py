"""Every parallel mode of the transformer tagger against the port's own
single-device tagger with dropout 0.1, and a pipelined run resumed from
a checkpoint.

The port keys each dropout draw by (seed, step, layer, the element's
index in the whole batch's tensor), so a mode draws the single-device
mask on every shard and microbatch; ``jax.random`` and the port's hash
never agree, so these are held against the port, not the reference.
Float32 (``layers.COMPUTE``), 4 entries, 16 sentences at batch 8, two
steps. Tolerances: the losses within 1e-5 and each tensor within 1e-4
of its update's size (the ranks' gradients add in another order). The
pp × ep mode takes one microbatch, so that its rank routes the whole
batch as the single device does. The resumed pp run is bit for bit the
uninterrupted one.
"""

import _torch_threads  # noqa: F401  (caps torch threads under xdist)

import numpy as np
import pytest
import torch

from _torch_modes import BASE, MODES, bound, torch_logger, train
from rafiki_torch.datasets import make_synthetic_corpus_dataset
from rafiki_torch.model.bridge import dense_to_jax
from rafiki_torch.models import TorchTransformerTagger, layers

KNOBS = dict(BASE, dropout=0.1, learning_rate=3e-3, batch_size=8,
             max_epochs=1)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return make_synthetic_corpus_dataset(
        str(tmp_path_factory.mktemp("drop")), n_train=16, n_val=8,
        vocab=100, n_tags=5, max_len=16, seed=1)


def _params(m):
    return {k: v for k, v in m.dump_parameters().items()
            if not k.startswith("_meta/")}


@pytest.mark.parametrize("mode", list(MODES))
def test_a_mode_trains_as_the_single_device_tagger(mode, corpus,
                                                   monkeypatch):
    monkeypatch.setattr(layers, "COMPUTE", torch.float32)
    extra = dict(MODES[mode])
    if mode == "pp_ep":
        extra["pp_microbatches"] = 1
    moe = {k: v for k, v in extra.items() if k == "moe_experts"}
    single = TorchTransformerTagger(device="cpu", **KNOBS, **moe)
    init = dense_to_jax(single.create_module(5).state_dict())
    s_rec = train(torch_logger, single, corpus[0])
    with bound():
        m = TorchTransformerTagger(device="cpu", **KNOBS, **extra)
        m_rec = train(torch_logger, m, corpus[0])
        assert m.mesh.size == 4
    assert abs(s_rec[0]["loss"] - m_rec[0]["loss"]) <= 1e-5
    a, b = _params(single), _params(m)
    assert set(a) == set(b) == set(init)
    for k in a:
        step = np.linalg.norm(a[k] - init[k])
        assert step > 0, k
        assert np.linalg.norm(b[k] - a[k]) <= 1e-4 * step, k


def test_a_pipelined_run_resumes_bit_for_bit(corpus, tmp_path):
    """pp 2 with dropout (ref tests/test_transformer.py:178): 2 epochs
    with the final state kept, resumed to 4 under one 4-epoch schedule,
    equal the uninterrupted 4 epochs."""
    knobs = dict(KNOBS, pipeline_parallel=2)
    ck = str(tmp_path / "ck")
    with bound(2):
        leg1 = TorchTransformerTagger(device="cpu", **dict(knobs,
                                                           max_epochs=2))
        train(torch_logger, leg1, corpus[0], checkpoint_dir=ck,
              checkpoint_final_epoch=True, schedule_total_epochs=4)
        leg2 = TorchTransformerTagger(device="cpu", **dict(knobs,
                                                           max_epochs=4))
        recs = train(torch_logger, leg2, corpus[0], checkpoint_dir=ck,
                     checkpoint_final_epoch=True, schedule_total_epochs=4)
        ref = TorchTransformerTagger(device="cpu", **dict(knobs,
                                                          max_epochs=4))
        train(torch_logger, ref, corpus[0], schedule_total_epochs=4)
        assert dict(ref.mesh.shape)["pp"] == 2
    assert [r["epoch"] for r in recs] == [2, 3]
    a, b = _params(leg2), _params(ref)
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
