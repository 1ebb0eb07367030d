"""TorchFeedForward (the port) against JaxFeedForward on the CPU.

Both packages load the same seeded numpy parameters through
``load_parameters`` (or start a short training run from them as
``shared_params``); the JAX side runs as its own tests run it, on the
8-device CPU mesh of ``tests/conftest.py``, so the batch (32) is a
multiple of 8 and both take the same steps.

Tolerances, from bf16 rounding. Both run flax's ``Dense(dtype=bf16)``:
bf16 products of f32 accumulations, a bf16 bias add, bf16 logits. The
two frameworks sum in different orders, so a logit may land on a
neighbouring bf16 value: one ulp of a logit below 4 in magnitude is
2^-6, which moves a probability by at most 0.25 · 2^-6 = 3.9e-3
(``PROB_ATOL``). In training, each gradient carries that rounding and
Adam divides by its running magnitude: Adam's first step is ±lr on
every element, so an element whose gradient is near zero may step the
other way (2% of the update's norm after one step at lr 1e-2), and the
difference grows with each step as the two runs see slightly different
weights. Over the 8 steps here the epoch loss stays within 5e-3 and each
parameter's update differs between the packages by at most 10% of its
size (relative Frobenius norm); the measured worst cases are 2.2e-3 and
5.2%, at lr 1e-2.
"""

import _torch_threads  # noqa: F401  (caps torch threads under xdist)
import numpy as np
import pytest

from rafiki_tpu.model.knobs import FixedKnob as JaxFixedKnob
from rafiki_tpu.model.logger import logger as jax_logger
from rafiki_tpu.models.feedforward import JaxFeedForward
from rafiki_torch.datasets import (make_synthetic_image_dataset,
                                   prepare_sklearn_digits)
from rafiki_torch.model import FixedKnob, test_model_class
from rafiki_torch.model.bridge import dense_from_jax, dense_to_jax
from rafiki_torch.model.logger import logger as torch_logger
from rafiki_torch.models import TorchFeedForward

SHAPE = (12, 12, 1)
N_CLASSES = 4
PROB_ATOL = 3.9e-3
LOSS_ATOL = 5e-3
UPDATE_RTOL = 0.10


def _params(seed=0, shape=SHAPE, n_classes=N_CLASSES):
    """Supernet parameters in the reference's flat names."""
    rng = np.random.default_rng(seed)
    widths = [int(np.prod(shape)), 128, 128, 128, n_classes]
    p = {}
    for i in range(4):
        p[f"params/Dense_{i}/kernel"] = (
            rng.standard_normal((widths[i], widths[i + 1]))
            / np.sqrt(widths[i])).astype(np.float32)
        p[f"params/Dense_{i}/bias"] = (
            0.1 * rng.standard_normal(widths[i + 1])).astype(np.float32)
    p["_meta/n_classes"] = np.asarray(n_classes)
    p["_meta/image_shape"] = np.asarray(shape)
    return p


def _knobs(count, units, **extra):
    return dict(hidden_layer_count=count, hidden_layer_units=units,
                learning_rate=1e-3, batch_size=32, **extra)


def _pair(knobs, params):
    jm = JaxFeedForward(**JaxFeedForward.validate_knobs(knobs))
    jm.load_parameters(params)
    tm = TorchFeedForward(device="cpu",
                          **TorchFeedForward.validate_knobs(knobs))
    tm.load_parameters(params)
    return jm, tm


MASKS = [(1, 16), (2, 77), (3, 128)]


@pytest.mark.parametrize("count,units", MASKS)
@pytest.mark.parametrize("kind", ["uint8", "float", "2d", "mixed"])
def test_predict_matches_jax(count, units, kind):
    jm, tm = _pair(_knobs(count, units), _params())
    rng = np.random.default_rng(1)
    u8 = rng.integers(0, 256, (37, *SHAPE), dtype=np.uint8)
    if kind == "uint8":
        queries = list(u8)
    elif kind == "float":
        queries = [x.astype(np.float32) / 255.0 for x in u8]
    elif kind == "2d":
        queries = [x[..., 0] for x in u8]
    else:
        queries = [x if i % 2 else x.astype(np.float32) / 255.0
                   for i, x in enumerate(u8)]
    ref = np.asarray(jm.predict(queries))
    out = np.asarray(tm.predict(queries))
    assert out.shape == (37, N_CLASSES)
    np.testing.assert_allclose(out.sum(-1), 1.0, atol=1e-5)
    np.testing.assert_allclose(out, ref, atol=PROB_ATOL, rtol=0)
    jm.destroy()
    tm.destroy()


def test_uint8_and_float_queries_agree():
    """A uint8 query and its normalised float are the same image."""
    _, tm = _pair(_knobs(2, 64), _params())
    u8 = np.random.default_rng(2).integers(0, 256, (5, *SHAPE),
                                           dtype=np.uint8)
    a = tm.predict(list(u8))
    b = tm.predict([x.astype(np.float32) / 255.0 for x in u8])
    np.testing.assert_allclose(a, b, atol=1e-6)


def test_predict_chunks_and_rejects_bad_shapes():
    _, tm = _pair(_knobs(3, 128), _params())
    u8 = np.random.default_rng(3).integers(0, 256, (5, *SHAPE),
                                           dtype=np.uint8)
    whole = tm.predict(list(u8))
    tm.max_predict_batch = 2
    np.testing.assert_allclose(tm.predict(list(u8)), whole, atol=1e-6)
    assert tm.predict([]) == []
    with pytest.raises(ValueError, match="query shape"):
        tm.predict([np.zeros((11, 12, 1), np.uint8)])
    proba = tm.predict_proba(u8)
    assert proba.dtype == np.float32
    np.testing.assert_allclose(proba, whole, atol=1e-6)
    assert tm.predict_submit(list(u8[:2]))() == tm.predict(list(u8[:2]))


def test_parameters_round_trip_exactly():
    p = _params()
    _, tm = _pair(_knobs(1, 16), p)
    out = tm.dump_parameters()
    assert set(out) == set(p)
    for k in p:
        assert out[k].shape == np.asarray(p[k]).shape, k
        np.testing.assert_array_equal(out[k], p[k])
    state = dense_from_jax(p)
    assert state["Dense_0.weight"].shape == (128, int(np.prod(SHAPE)))
    back = dense_to_jax(state)
    for k in back:
        np.testing.assert_array_equal(back[k], p[k])


def test_model_before_training_raises():
    tm = TorchFeedForward(device="cpu",
                          **TorchFeedForward.validate_knobs(_knobs(1, 16)))
    with pytest.raises(RuntimeError, match="train"):
        tm.predict([np.zeros(SHAPE, np.uint8)])


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    return make_synthetic_image_dataset(
        str(tmp_path_factory.mktemp("ff")), n_train=256, n_val=64,
        image_shape=SHAPE, n_classes=N_CLASSES)


class JaxOneEpoch(JaxFeedForward):
    @staticmethod
    def get_knob_config():
        cfg = dict(JaxFeedForward.get_knob_config())
        cfg["max_epochs"] = JaxFixedKnob(1)
        cfg["batch_size"] = JaxFixedKnob(32)
        return cfg


class TorchOneEpoch(TorchFeedForward):
    @staticmethod
    def get_knob_config():
        cfg = dict(TorchFeedForward.get_knob_config())
        cfg["max_epochs"] = FixedKnob(1)
        cfg["batch_size"] = FixedKnob(32)
        return cfg


def _records(sink_owner, model, *args, **kwargs):
    recs = []
    prior = sink_owner.current_sink()
    sink_owner.set_sink(recs.append)
    try:
        model.train(*args, **kwargs)
    finally:
        sink_owner.set_sink(prior)
    return [r["values"] for r in recs
            if r["type"] == "values" and "epoch" in r.get("values", {})]


@pytest.mark.parametrize("count,units,lr", [(2, 100, 3e-3), (3, 128, 1e-2)])
def test_short_training_matches_jax(synth, count, units, lr):
    train, val = synth
    p = _params(seed=5)
    knobs = dict(hidden_layer_count=count, hidden_layer_units=units,
                 learning_rate=lr)
    jm = JaxOneEpoch(**JaxOneEpoch.validate_knobs(knobs))
    tm = TorchOneEpoch(device="cpu", **TorchOneEpoch.validate_knobs(knobs))
    jrec = _records(jax_logger, jm, train, shared_params=p)
    trec = _records(torch_logger, tm, train, shared_params=p)
    assert len(jrec) == len(trec) == 1
    assert set(trec[0]) >= {"epoch", "loss", "train_acc", "steps_per_sec"}
    assert abs(trec[0]["loss"] - jrec[0]["loss"]) <= LOSS_ATOL
    # 8 steps of 32 examples: at most 2 flipped predictions.
    assert abs(trec[0]["train_acc"] - jrec[0]["train_acc"]) <= 2 / 256
    jp, tp = jm.dump_parameters(), tm.dump_parameters()
    assert set(jp) == set(tp)
    for k in sorted(jp):
        if k.startswith("_"):
            continue
        a, b, start = np.asarray(jp[k]), tp[k], p[k]
        step = np.linalg.norm(a - start)
        if step == 0:  # a layer the count mask switches off
            np.testing.assert_array_equal(b, start)
            continue
        assert np.linalg.norm(b - a) <= UPDATE_RTOL * step, k
    assert abs(tm.evaluate(val) - jm.evaluate(val)) <= 2 / 64


# The FeedForward row of examples/scripts/accuracy_parity.py.
DIGITS_KNOBS = {"hidden_layer_count": 2, "hidden_layer_units": 128,
                "learning_rate": 3e-3, "batch_size": 64, "max_epochs": 5}


def test_model_class_on_uci_digits(tmp_path):
    """BASELINE.md's band for JaxFeedForward on UCI digits (>= 0.90),
    at the knobs of the reference's accuracy-parity script."""
    train, val = prepare_sklearn_digits(str(tmp_path))
    digits = np.load(val)["images"]
    result = test_model_class(TorchFeedForward, "IMAGE_CLASSIFICATION",
                              train, val, test_queries=list(digits[:4]),
                              knobs=DIGITS_KNOBS, device="cpu")
    assert result.score >= 0.90, result
    assert len(result.predictions) == 4
    epochs = [r["values"] for r in result.log_records
              if r["type"] == "values" and "epoch" in r["values"]]
    assert [e["epoch"] for e in epochs] == list(range(5))


@pytest.mark.parametrize("weight_decay", [0.0, 1e-2])
def test_scheduled_adam_matches_optax(weight_decay):
    """The port's optimizer against the reference's on the same
    gradients: optax's Adam (eps outside the square root), the cosine
    schedule to alpha 0.01 read at the count before its increment, and
    -learning_rate; with weight decay, ``traced_hyperparam_optimizer``'s
    chain, ``add_decayed_weights`` before ``scale_by_adam`` (L2 decay
    coupled into the moments). f32 throughout: agreement to f32
    rounding."""
    import jax.numpy as jnp
    import optax
    import torch

    from rafiki_torch.model.optim import cosine_decay_schedule, scheduled_adam

    lr, total = 3e-3, 6
    sched = optax.cosine_decay_schedule(1.0, decay_steps=total, alpha=0.01)
    ours_sched = cosine_decay_schedule(1.0, total, alpha=0.01)
    for c in range(total + 3):
        assert abs(ours_sched(c) - float(sched(c))) <= 1e-7
    tx = optax.chain(optax.add_decayed_weights(weight_decay),
                     optax.scale_by_adam(),
                     optax.scale_by_schedule(sched),
                     optax.scale(-1.0 * lr))
    rng = np.random.default_rng(0)
    w0 = rng.standard_normal(50).astype(np.float32)
    grads = [rng.standard_normal(50).astype(np.float32) * 10 ** -k
             for k in range(total + 2)]
    w = jnp.asarray(w0)
    state = tx.init(w)
    for g in grads:
        upd, state = tx.update(jnp.asarray(g), state, w)
        w = optax.apply_updates(w, upd)
    p = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    opt = scheduled_adam([p], lr, total, weight_decay=weight_decay)
    for g in grads:
        opt.zero_grad()
        p.grad = torch.from_numpy(g.copy())
        opt.step()
    np.testing.assert_allclose(p.detach().numpy(), np.asarray(w), atol=2e-7,
                               rtol=1e-6)
