"""TorchTransformerLM.train (the port) against JaxTransformerLM on the CPU.

Both load the same seeded numpy parameters at the TINY shape of
``tests/test_lm.py`` (batch 8: the reference rounds its batch to the
8-device CPU mesh of the test configuration, the port runs one device).
The JAX side runs its Pallas kernels in interpret mode, the port its
plain attention path, forward and backward.

Tolerances, and why:
- one step's loss: 1e-3 absolute (about 2e-5 seen). Both run a bf16
  residual stream and bf16 matmuls that round at different places.
- one step's gradient per parameter: relative Frobenius error 3e-2
  (under 1e-2 seen). A bf16 product rounds at 2^-8 relative, and the
  backward chains a few such roundings.
- 16 trained steps, chunk losses: 2e-3 absolute (about 2e-4 seen).
- 16 trained steps, parameters: the update ``p_16 − p_0`` within 5e-2
  relative Frobenius error (about 1e-2 seen) and every entry within
  1e-2 (about 3e-3 seen, at learning rate 1e-3). Adam steps each entry by
  about the learning rate whatever its gradient's size, so where the two
  gradients differ in sign a step differs by up to twice the learning
  rate.
- The schedule: 1e-9 (optax computes it in f32).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rafiki_tpu.datasets import \
    make_synthetic_token_dataset as jax_make_tokens
from rafiki_tpu.model.logger import logger as jax_logger
from rafiki_tpu.model.loop_ckpt import epoch_rng as jax_epoch_rng
from rafiki_tpu.models import JaxTransformerLM
from rafiki_torch.datasets import make_synthetic_token_dataset
from rafiki_torch.model.bridge import lm_to_jax
from rafiki_torch.model.dataset import load_token_dataset
from rafiki_torch.model.logger import logger
from rafiki_torch.model.loop_ckpt import epoch_rng
from rafiki_torch.model.optim import adamw, warmup_cosine_decay_schedule
from rafiki_torch.models import TorchTransformerLM
from test_torch_lm import _params

TINY = {"d_model": 256, "n_layers": 2, "seq_len": 256, "batch_size": 8,
        "learning_rate": 1e-3, "train_steps": 200, "vocab_size": 512,
        "quick_train": False}
NAMES = sorted(_params())


def _torch_model(**over):
    return TorchTransformerLM(device="cpu", **dict(
        TorchTransformerLM.validate_knobs(TINY), **over))


def _records(run):
    """The ``values`` records that ``run()`` logs to the port's logger."""
    records = []
    prev = logger.current_sink()
    logger.set_sink(records.append)
    try:
        run()
    finally:
        logger.set_sink(prev)
    return [r["values"] for r in records if r.get("type") == "values"]


@pytest.fixture(scope="module")
def token_data(tmp_path_factory):
    return make_synthetic_token_dataset(
        str(tmp_path_factory.mktemp("lm_train")), n_train=1 << 15,
        n_val=1 << 12, vocab_size=512, branching=2)


@pytest.fixture(scope="module")
def one_step():
    """One step's loss and gradients on the same weights and windows:
    the port's ``_loss`` and ``backward``, and ``jax.value_and_grad`` of
    the same loss built from ``JaxTransformerLM._forward`` and optax's
    cross-entropy."""
    p = _params()
    win = np.random.default_rng(5).integers(0, 512, (4, 257))
    jm = JaxTransformerLM(**JaxTransformerLM.validate_knobs(TINY))
    jm.load_parameters(p)

    def loss_fn(params):
        logits = jm._forward(params, jnp.asarray(win[:, :-1], jnp.int32))
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.asarray(win[:, 1:])).mean()

    jloss, jgrads = jax.value_and_grad(loss_fn)(jm._params)
    jgrads = {"embed": jgrads["embed"], "lnf": jgrads["lnf"],
              **{f"layers/{k}": v for k, v in jgrads["layers"].items()}}
    tm = _torch_model()
    tm.load_parameters(p)
    loss, _ = tm._loss(torch.from_numpy(win))
    loss.backward()
    tgrads = lm_to_jax({k: w.grad for k, w in tm._net.named_parameters()})
    return float(jloss), {k: np.asarray(v) for k, v in jgrads.items()}, \
        float(loss.detach()), tgrads


def test_one_step_loss_matches_jax(one_step):
    jloss, _, tloss, _ = one_step
    assert abs(tloss - jloss) <= 1e-3


@pytest.mark.parametrize("name", NAMES)
def test_one_step_gradient_matches_jax(one_step, name):
    _, jgrads, _, tgrads = one_step
    ref, got = jgrads[name], tgrads[name]
    assert got.shape == ref.shape and got.dtype == np.float32
    err = np.linalg.norm(got - ref) / np.linalg.norm(ref)
    assert err <= 3e-2, err


@pytest.fixture(scope="module")
def trained(token_data):
    """Both packages train 16 steps (two chunks of 8) from the same
    loaded params on the same stream."""
    train_path, _ = token_data
    p = _params()
    jm = JaxTransformerLM(**dict(JaxTransformerLM.validate_knobs(TINY),
                                 train_steps=16))
    jm.load_parameters(p)
    jrecords = []
    prev = jax_logger.current_sink()
    jax_logger.set_sink(jrecords.append)
    try:
        jm.train(train_path)
    finally:
        jax_logger.set_sink(prev)
    tm = _torch_model(train_steps=16)
    tm.load_parameters(p)
    trecords = _records(lambda: tm.train(train_path))
    jrecords = [r["values"] for r in jrecords if r.get("type") == "values"]
    out = (p, jrecords, jm.dump_parameters(), trecords, tm.dump_parameters())
    jm.destroy()
    tm.destroy()
    return out


def test_trained_chunk_losses_match_jax(trained):
    _, jrec, _, trec, _ = trained
    assert [r["step"] for r in trec] == [r["step"] for r in jrec] == [8, 16]
    for j, t in zip(jrec, trec):
        assert abs(t["loss"] - j["loss"]) <= 2e-3, (t, j)
        assert 0.0 <= t["token_acc"] <= 1.0
    # On the CPU there is no card whose peak a utilization could name.
    assert all("chip_util" not in r for r in trec)


@pytest.mark.parametrize("name", NAMES)
def test_trained_params_match_jax(trained, name):
    p0, _, jp, _, tp = trained
    assert tp[name].dtype == np.float32 and tp[name].shape == p0[name].shape
    ju, tu = jp[name] - p0[name], tp[name] - p0[name]
    assert np.linalg.norm(tu - ju) / np.linalg.norm(ju) <= 5e-2
    np.testing.assert_allclose(tp[name], jp[name], atol=1e-2, rtol=0)


def test_quick_train_cap(token_data):
    """quick_train caps the step budget (the AutoML trial contract), as
    ``tests/test_lm.py`` tests it for the reference; 16 steps are two
    chunks of ``steps_per_dispatch`` = 8."""
    train_path, _ = token_data
    m = TorchTransformerLM(device="cpu", **dict(
        TorchTransformerLM.validate_knobs(dict(TINY, train_steps=5000,
                                               quick_train=True)),
        trial_steps=16))
    steps = [r["step"] for r in _records(lambda: m.train(train_path))]
    assert steps and max(steps) == 16, steps  # capped, not 5000
    assert m.dump_parameters()
    m.destroy()


def test_tail_chunk_is_short(token_data):
    train_path, _ = token_data
    m = _torch_model(train_steps=11)
    assert [r["step"] for r in _records(lambda: m.train(train_path))] \
        == [8, 11]
    m.destroy()


@pytest.mark.parametrize("remat,per_layer", [("none", 1), ("full", 2),
                                             ("dots", 2)])
def test_remat_policy(remat, per_layer):
    """Every policy gives the same loss and gradients; "full" and "dots"
    rerun the attention forward in the backward (on the card: K1 launches
    per step = per_layer × n_layers)."""
    p = _params()
    win = torch.from_numpy(np.random.default_rng(6).integers(0, 512, (2, 257)))
    results = {}
    for policy in ("none", remat):
        m = _torch_model(remat=policy)
        m.load_parameters(p)
        calls = []
        attention = m.attention

        def counted(*args, **kwargs):
            calls.append(1)
            return attention(*args, **kwargs)

        m.attention = counted
        loss, _ = m._loss(win)
        loss.backward()
        results[policy] = (float(loss.detach()), len(calls), {
            k: w.grad.clone() for k, w in m._net.named_parameters()})
    loss, calls, grads = results[remat]
    assert calls == per_layer * TINY["n_layers"]
    assert loss == pytest.approx(results["none"][0], abs=1e-6)
    for k, g in grads.items():
        torch.testing.assert_close(g, results["none"][2][k], atol=1e-6,
                                   rtol=1e-5)


def test_unknown_remat_policy_raises():
    m = _torch_model(remat="sometimes")
    m.load_parameters(_params())
    with pytest.raises(ValueError, match="remat"):
        m._loss(torch.zeros((1, 257), dtype=torch.int64))


def test_train_from_nothing_inits_from_the_seed(token_data):
    """With nothing loaded, train initialises at the reference's scales
    from the ``seed`` knob; the same seed gives the same run."""
    train_path, _ = token_data
    dumps = []
    for _ in range(2):
        # Two steps: the reference's schedule needs one past its warmup.
        m = _torch_model(train_steps=2, steps_per_dispatch=2)
        m.train(train_path)
        dumps.append(m.dump_parameters())
        m.destroy()
    a, b = dumps
    assert set(a) == set(NAMES)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    # Adam moves a weight by about the learning rate a step: the two
    # steps by at most 1e-4 + 1e-3, far below these scales.
    assert abs(a["embed"].std() - 0.02) < 1e-3
    assert abs(a["layers/w2"].std() - 1 / math.sqrt(4 * 256)) < 1e-3
    np.testing.assert_allclose(a["lnf"], 1.0, atol=2e-3)


def test_predict_after_train_sees_the_trained_weights(token_data):
    """Predict runs on cached bf16 casts; training drops the cache."""
    train_path, val_path = token_data
    m = _torch_model(train_steps=8)
    m.load_parameters(_params())
    q = load_token_dataset(val_path).ids[:100].tolist()
    before = m.predict([q])
    _records(lambda: m.train(train_path))
    after = m.predict([q])
    assert after != before
    m2 = _torch_model()
    m2.load_parameters(m.dump_parameters())
    assert m2.predict([q]) == pytest.approx(after, abs=1e-6)


@pytest.mark.parametrize("bad", ["vocab", "short"])
def test_train_rejects_a_dataset_it_cannot_use(bad, tmp_path):
    from rafiki_torch.model.dataset import write_token_dataset

    ids, vocab = np.zeros(1000, np.int32), 512
    if bad == "vocab":
        vocab = 4096
    else:
        ids = ids[:257]
    path = write_token_dataset(ids, vocab, str(tmp_path / bad))
    m = _torch_model()
    with pytest.raises(ValueError):
        m.train(path)


@pytest.mark.parametrize("total", [2, 5, 16, 100, 20000])
def test_schedule_matches_optax(total):
    lr = 3e-4
    ref = optax.warmup_cosine_decay_schedule(
        init_value=lr * 0.1, peak_value=lr, warmup_steps=max(1, total // 10),
        decay_steps=total, end_value=lr * 0.1)
    got = warmup_cosine_decay_schedule(lr * 0.1, lr, max(1, total // 10),
                                       total, lr * 0.1)
    counts = sorted({0, 1, total // 10, total // 2, total - 1, total,
                     total + 3})
    np.testing.assert_allclose([got(c) for c in counts],
                               [float(ref(c)) for c in counts],
                               atol=1e-9, rtol=0)


def test_adamw_steps_match_optax():
    """Three AdamW updates under the schedule: torch's AdamW with optax
    ``adamw``'s defaults gives optax's parameters (f32, 1e-6)."""
    rng = np.random.default_rng(7)
    p0 = rng.standard_normal((4, 5)).astype(np.float32)
    grads = [rng.standard_normal((4, 5)).astype(np.float32) for _ in range(3)]
    schedule = warmup_cosine_decay_schedule(1e-3, 1e-2, 1, 3, 1e-3)
    tx = optax.adamw(optax.warmup_cosine_decay_schedule(
        init_value=1e-3, peak_value=1e-2, warmup_steps=1, decay_steps=3,
        end_value=1e-3))
    jp, state = jnp.asarray(p0), None
    state = tx.init(jp)
    w = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = adamw([w], schedule(0))
    for i, g in enumerate(grads):
        updates, state = tx.update(jnp.asarray(g), state, jp)
        jp = optax.apply_updates(jp, updates)
        opt.param_groups[0]["lr"] = schedule(i)
        w.grad = torch.from_numpy(g)
        opt.step()
    np.testing.assert_allclose(w.detach().numpy(), np.asarray(jp),
                               atol=1e-6, rtol=1e-6)


def test_synthetic_stream_and_windows_match_jax(tmp_path):
    """The port's copies of the generator and of ``epoch_rng`` give the
    reference's stream and window starts."""
    a = make_synthetic_token_dataset(str(tmp_path / "t"), n_train=4096,
                                     n_val=512, vocab_size=512)
    b = jax_make_tokens(str(tmp_path / "j"), n_train=4096, n_val=512,
                        vocab_size=512)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(load_token_dataset(x).ids,
                                      load_token_dataset(y).ids)
    np.testing.assert_array_equal(epoch_rng(3, 0).integers(0, 999, 64),
                                  jax_epoch_rng(3, 0).integers(0, 999, 64))
