"""The port's Adam optimizers against the reference's on the CPU.

``scheduled_adam`` with weight decay is the reference's
``JaxModel.traced_hyperparam_optimizer(opt="adam", weight_decay=True)``:
``add_decayed_weights`` chained before ``scale_by_adam``, L2 decay
coupled into Adam's moments (ViT's and the CNN's optimizer).
``scheduled_adamw`` is ``optax.adamw`` (decoupled decay) under the
transformer tagger's warm-up cosine. Same gradients, f32 throughout:
agreement to f32 rounding, atol 2e-7 and rtol 1e-6.
"""

import _torch_threads  # noqa: F401  (caps torch threads under xdist)
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rafiki_torch.model.optim import (scheduled_adam, scheduled_adamw,
                                      warmup_cosine_decay_schedule)
from rafiki_tpu.model.jax_model import JaxModel

ATOL, RTOL = 2e-7, 1e-6


def _run_both(tx, make_ours, steps, n=50, seed=0):
    rng = np.random.default_rng(seed)
    w0 = rng.standard_normal(n).astype(np.float32)
    grads = [rng.standard_normal(n).astype(np.float32) * 10 ** -(k % 3)
             for k in range(steps)]
    w = jnp.asarray(w0)
    state = tx.init(w)
    for g in grads:
        upd, state = tx.update(jnp.asarray(g), state, w)
        w = optax.apply_updates(w, upd)
    p = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    opt = make_ours([p])
    for g in grads:
        opt.zero_grad()
        p.grad = torch.from_numpy(g.copy())
        opt.step()
    return p.detach().numpy(), np.asarray(w)


def test_adam_weight_decay_is_the_reference_chain():
    """``scheduled_adam(weight_decay=wd)`` against the reference's own
    ``traced_hyperparam_optimizer(None, spe, epochs, opt="adam",
    weight_decay=True)`` with its injected hyperparameters set, as
    ``JaxModel.train`` sets them. AdamW's decoupled decay ends about
    2e-2 away at these values."""
    lr, wd, spe, epochs = 3e-3, 1e-3, 3, 2
    tx = JaxModel.traced_hyperparam_optimizer(None, spe, epochs, opt="adam",
                                              weight_decay=True)
    rng = np.random.default_rng(1)
    w0 = rng.standard_normal(40).astype(np.float32)
    grads = [rng.standard_normal(40).astype(np.float32)
             for _ in range(spe * epochs)]
    w = jnp.asarray(w0)
    state = tx.init(w)
    state.hyperparams["learning_rate"] = jnp.asarray(lr, jnp.float32)
    state.hyperparams["weight_decay"] = jnp.asarray(wd, jnp.float32)
    for g in grads:
        upd, state = tx.update(jnp.asarray(g), state, w)
        w = optax.apply_updates(w, upd)
    p = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    opt = scheduled_adam([p], lr, spe * epochs, weight_decay=wd)
    for g in grads:
        opt.zero_grad()
        p.grad = torch.from_numpy(g.copy())
        opt.step()
    np.testing.assert_allclose(p.detach().numpy(), np.asarray(w),
                               atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("total", [10, 40])
def test_scheduled_adamw_matches_optax_adamw(total):
    """The tagger's optimizer: ``optax.adamw(warmup_cosine_decay_schedule(
    lr·0.1 → lr over total//10, to lr·0.02), weight_decay=1e-3)``
    (``transformer.py:580-586``)."""
    lr, wd = 5e-3, 1e-3
    wsteps = max(1, total // 10)
    tx = optax.adamw(optax.warmup_cosine_decay_schedule(
        init_value=lr * 0.1, peak_value=lr, warmup_steps=wsteps,
        decay_steps=total, end_value=lr * 0.02), weight_decay=wd)
    ours, ref = _run_both(tx, lambda ps: scheduled_adamw(
        ps, lr, warmup_cosine_decay_schedule(0.1, 1.0, wsteps, total, 0.02),
        total, weight_decay=wd), total)
    np.testing.assert_allclose(ours, ref, atol=ATOL, rtol=RTOL)


def test_the_two_decays_differ():
    """Coupled and decoupled decay are different updates: the test
    above would see the one taken for the other."""
    lr, wd, total = 3e-3, 1e-1, 8
    a, _ = _run_both(optax.identity(), lambda ps: scheduled_adam(
        ps, lr, total, weight_decay=wd), total)
    b, _ = _run_both(optax.identity(), lambda ps: scheduled_adamw(
        ps, lr, warmup_cosine_decay_schedule(1.0, 1.0, 1, total, 0.01),
        total, weight_decay=wd), total)
    assert np.abs(a - b).max() > 1e-4
