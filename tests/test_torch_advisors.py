"""The port's advisors (``BayesOptAdvisor``, ``EnasAdvisor`` and
``make_advisor``) against the JAX package's on the CPU.

The ENAS controller's weights are carried from the reference's flax
controller by the bridge (``dense_from_jax``), never drawn twice:
its logits for given actions agree within 1e-5 (f32 LSTM products summed
in two orders) and one to three REINFORCE updates under Adam within
1e-5 of each parameter's scale. The samplers draw from different
generators, so a search is compared on what does not depend on the
draws: phases, policies, params types and the final phase's
architecture.

The Gaussian process is held against scikit-learn's
``GaussianProcessRegressor``, which the CPU tests have and the card's
machine does not: the fitted log-hyperparameters within 1e-4 (two runs of
L-BFGS-B on the same objective; measured at most 1.4e-7), the
posterior mean and standard deviation within 1e-6 (measured at most
6.3e-11). A seeded 12-trial search proposes the reference's knobs.
"""

import _torch_threads  # noqa: F401  (caps torch threads under xdist)
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from rafiki_tpu.advisor import BayesOptAdvisor as JaxBayes
from rafiki_tpu.advisor import EnasAdvisor as JaxEnasAdvisor
from rafiki_tpu.advisor import make_advisor as jax_make_advisor
from rafiki_tpu.advisor.enas import _Controller as JaxController
from rafiki_tpu.model import (ArchKnob as JaxArchKnob,
                              CategoricalKnob as JaxCategoricalKnob,
                              FixedKnob as JaxFixedKnob,
                              FloatKnob as JaxFloatKnob,
                              IntegerKnob as JaxIntegerKnob,
                              PolicyKnob as JaxPolicyKnob)
from rafiki_tpu.models import JaxDenseNet, JaxEnas, JaxFeedForward
from rafiki_torch.advisor import (AshaAdvisor, BayesOptAdvisor,
                                  EnasAdvisor, PbtAdvisor, RandomAdvisor,
                                  make_advisor)
from rafiki_torch.advisor.bayes import GaussianProcess
from rafiki_torch.advisor.enas import _Controller
from rafiki_torch.constants import ParamsType
from rafiki_torch.model import (ArchKnob, CategoricalKnob, FixedKnob,
                                FloatKnob, IntegerKnob, PolicyKnob)
from rafiki_torch.model.bridge import dense_from_jax, dense_to_jax
from rafiki_torch.models import TorchDenseNet, TorchEnas, TorchFeedForward


def _enas_config(arch, fixed, policy):
    return {
        "arch": arch([[0, 1, 2], [0, 1], [0, 1, 2, 3], [0, 1, 2, 3, 4]]),
        "lr": fixed(1e-3),
        "share": policy("SHARE_PARAMS"),
        "quick": policy("QUICK_TRAIN"),
        "down": policy("DOWNSCALE"),
        "other": policy("SOME_OTHER_POLICY"),
    }


ENAS = _enas_config(ArchKnob, FixedKnob, PolicyKnob)
JAX_ENAS = _enas_config(JaxArchKnob, JaxFixedKnob, JaxPolicyKnob)
N_CHOICES = (3, 2, 4, 5)


def _flat(tree):
    return {k: np.asarray(v) for k, v in
            traverse_util.flatten_dict(tree, sep="/").items()}


def _jax_controller(seed=3):
    model = JaxController(n_choices=N_CHOICES)
    params = model.init(jax.random.key(seed), jnp.zeros((4,), jnp.int32))
    # Non-zero hidden biases, so that the bridge's bias mapping shows.
    flat = _flat(params)
    rng = np.random.default_rng(seed)
    for k in flat:
        if k.endswith("/bias"):
            flat[k] = (0.1 * rng.standard_normal(flat[k].shape)).astype(
                np.float32)
    return model, flat


def _port_advisor(flat, **kw):
    adv = EnasAdvisor(ENAS, seed=0, device="cpu", **kw)
    adv.model.load_state_dict(dense_from_jax(flat))
    return adv


def _logits(adv, actions):
    """The port controller's teacher-forced logits (n_pos, max_c)."""
    with torch.no_grad():
        return adv.model(adv._actions(actions)).numpy()


# --- (1) the controller's bridge ---


def test_controller_bridge_round_trip_is_exact():
    _, flat = _jax_controller()
    state = dense_from_jax(flat)
    own = _Controller(N_CHOICES).state_dict()
    assert set(state) == set(own)
    for k in own:
        assert tuple(state[k].shape) == tuple(own[k].shape), k
    assert not state["LSTMCell_0.bias_ih"].any()
    back = dense_to_jax(state)
    assert set(back) == set(flat)
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k], err_msg=k)


# --- (9) the controller and the ENAS advisor ---


@pytest.mark.parametrize("actions", [[0, 0, 0, 0], [2, 1, 3, 4],
                                     [1, 0, 2, 1]])
def test_controller_logits_match_jax(actions):
    model, flat = _jax_controller()
    ref = np.asarray(model.apply(traverse_util.unflatten_dict(
        {k: jnp.asarray(v) for k, v in flat.items()}, sep="/"),
        jnp.asarray(actions, jnp.int32)))
    adv = _port_advisor(flat)
    out = _logits(adv, actions)
    assert out.shape == (4, 5)
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-5)
    assert (out[1, 2:] == -1e9).all() and (out[0, 3:] == -1e9).all()


def test_reinforce_updates_match_jax():
    """Three updates (Adam's bias correction moves with the count)."""
    _, flat = _jax_controller()
    jadv = JaxEnasAdvisor(JAX_ENAS, seed=0)
    params = traverse_util.unflatten_dict(
        {k: jnp.asarray(v) for k, v in flat.items()}, sep="/")
    opt_state = jadv._tx.init(params)
    adv = _port_advisor(flat)
    for actions, advantage in (([2, 1, 3, 4], 0.3), ([0, 0, 1, 2], -0.7),
                               ([1, 1, 3, 0], 0.05)):
        params, opt_state = jadv._update_fn(
            params, opt_state, jnp.asarray(actions, jnp.int32),
            jnp.float32(advantage))
        adv._update(np.asarray(actions), advantage)
    ref = _flat(params)
    out = dense_to_jax(adv.model.state_dict())
    for k in ref:
        scale = max(np.abs(flat[k]).max(), 1e-3)
        np.testing.assert_allclose(out[k], ref[k], atol=1e-5 * scale,
                                   rtol=0, err_msg=k)
        if k.endswith("/kernel"):
            assert np.abs(ref[k] - flat[k]).max() > 1e-3, k


def test_arch_probs_match_jax():
    _, flat = _jax_controller()
    jadv = JaxEnasAdvisor(JAX_ENAS, seed=0)
    jadv._params = traverse_util.unflatten_dict(
        {k: jnp.asarray(v) for k, v in flat.items()}, sep="/")
    np.testing.assert_allclose(_port_advisor(flat).arch_probs(),
                               jadv.arch_probs(), atol=1e-6)


def test_sampling_follows_the_policy():
    """The one-pass sampler draws from the teacher-forced policy: the
    frequencies of the first two positions' 6 joint choices over 4,000
    draws lie within 0.03 of their probabilities (binomial std at most
    0.008)."""
    _, flat = _jax_controller()
    adv = _port_advisor(flat)
    probs = np.zeros((3, 2))
    for a0 in range(3):
        p0 = np.exp(_logits(adv, [a0, 0, 0, 0]))
        p0 /= p0.sum(-1, keepdims=True)
        probs[a0] = p0[0, a0] * p0[1, :2]
    counts = np.zeros((3, 2))
    for _ in range(4000):
        a = adv.model.sample(adv._gen)
        counts[a[0], a[1]] += 1
        assert a[2] < 4 and a[3] < 5
    np.testing.assert_allclose(counts / 4000, probs, atol=0.03)


def _score(arch):
    return float(sum(a * (i + 1) for i, a in enumerate(arch)) / 40.0)


def test_a_12_trial_search_has_the_references_phases():
    """``_is_final`` (counting a forgotten trial), the policies and the
    params types of each proposal, and the final phase retraining the
    best architecture, as the reference's."""
    jadv = JaxEnasAdvisor(JAX_ENAS, seed=0, total_trials=12,
                          final_train_frac=0.25)
    adv = EnasAdvisor(ENAS, seed=0, total_trials=12, final_train_frac=0.25,
                      device="cpu")
    seen = []
    for step in range(13):
        jp, tp = jadv.propose(), adv.propose()
        if jp is None:
            assert tp is None
            break
        assert tp.trial_no == jp.trial_no
        assert tp.params_type == jp.params_type
        for name in ("share", "quick", "down", "other"):
            assert tp.knobs[name] == jp.knobs[name], (step, name)
        final = tp.params_type == ParamsType.NONE
        assert final == adv._is_final(tp.trial_no) == jadv._is_final(
            jp.trial_no)
        if final:
            assert tp.knobs["arch"] == adv.best()[0]["arch"]
            assert jp.knobs["arch"] == jadv.best()[0]["arch"]
        if step == 4:
            jadv.forget(jp)
            adv.forget(tp)
        else:
            jadv.feedback(jp, _score(jp.knobs["arch"]))
            adv.feedback(tp, _score(tp.knobs["arch"]))
        seen.append((tp.params_type, tp.knobs["share"], tp.knobs["other"]))
    assert len(seen) == 13
    assert [s[0] for s in seen].count(ParamsType.NONE) == 3
    assert seen[0] == (ParamsType.GLOBAL_RECENT, True, False)
    assert adv.propose() is None


def test_enas_advisor_learns_good_arch():
    """The reference's own learning test, on the port."""
    adv = EnasAdvisor(ENAS, seed=0, total_trials=None, lr=5e-2,
                      device="cpu")
    target = [2, 1, 3, 4]
    for _ in range(60):
        p = adv.propose()
        assert p.params_type == ParamsType.GLOBAL_RECENT
        adv.feedback(p, float(sum(a == t for a, t in
                                  zip(p.knobs["arch"], target)) / 4.0))
    probs = adv.arch_probs()
    assert probs[0, 2] > 0.4 and probs[2, 3] > 0.35, probs


def test_enas_advisor_needs_one_arch_knob():
    with pytest.raises(ValueError, match="ArchKnob"):
        EnasAdvisor({"lr": FixedKnob(1.0)}, device="cpu")


# --- (10) the Gaussian process and the Bayes advisor ---


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_gaussian_process_matches_sklearn(seed):
    from sklearn.gaussian_process import GaussianProcessRegressor
    from sklearn.gaussian_process.kernels import ConstantKernel, Matern

    rng = np.random.default_rng(seed)
    d, n = 4, 5 + 3 * seed
    X, y = rng.random((n, d)), rng.standard_normal(n)
    kernel = ConstantKernel(1.0) * Matern(length_scale=np.full(d, 0.5),
                                          nu=2.5)
    ref = GaussianProcessRegressor(kernel=kernel, alpha=1e-4,
                                   normalize_y=False, n_restarts_optimizer=1,
                                   random_state=seed + 7)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref.fit(X, y)
    gp = GaussianProcess(d, alpha=1e-4, random_state=seed + 7).fit(X, y)
    np.testing.assert_allclose(gp.theta, ref.kernel_.theta, atol=1e-4)
    Xs = rng.random((64, d))
    mu_r, sd_r = ref.predict(Xs, return_std=True)
    mu, sd = gp.predict(Xs)
    np.testing.assert_allclose(mu, mu_r, atol=1e-6)
    np.testing.assert_allclose(sd, sd_r, atol=1e-6)


def _bayes_config(cat, fixed, flt, integer):
    return {"lr": flt(1e-4, 1e-1, is_exp=True), "units": integer(8, 64),
            "act": cat(["relu", "tanh"]), "epochs": fixed(3)}


def _quadratic(knobs):
    return float(-(np.log10(knobs["lr"]) + 2.0) ** 2
                 - ((knobs["units"] - 32) / 16.0) ** 2
                 + (0.1 if knobs["act"] == "tanh" else 0.0))


def test_a_seeded_bayes_search_proposes_the_references_knobs():
    """12 trials, 7 of them from the fitted GP."""
    jadv = JaxBayes(_bayes_config(JaxCategoricalKnob, JaxFixedKnob,
                                  JaxFloatKnob, JaxIntegerKnob), seed=4)
    adv = BayesOptAdvisor(_bayes_config(CategoricalKnob, FixedKnob,
                                        FloatKnob, IntegerKnob), seed=4)
    for _ in range(12):
        jp, tp = jadv.propose(), adv.propose()
        assert tp.knobs == jp.knobs
        jadv.feedback(jp, _quadratic(jp.knobs))
        adv.feedback(tp, _quadratic(tp.knobs))
    assert len(adv._y) == 12 and adv.best()[1] > -0.5


# --- F3: make_advisor's automatic choice ---


@pytest.mark.parametrize("port,ref", [
    (TorchFeedForward, JaxFeedForward), (TorchDenseNet, JaxDenseNet),
    (TorchEnas, JaxEnas)])
def test_make_advisor_chooses_as_the_reference(port, ref):
    expected = type(jax_make_advisor(ref.get_knob_config(),
                                     total_trials=8)).__name__
    got = make_advisor(port.get_knob_config(), total_trials=8,
                       device="cpu")
    assert type(got).__name__ == expected
    assert expected == {"TorchFeedForward": "BayesOptAdvisor",
                        "TorchDenseNet": "BayesOptAdvisor",
                        "TorchEnas": "EnasAdvisor"}[port.__name__]


def test_make_advisor_types():
    cfg = {"epochs": FixedKnob(3)}
    assert isinstance(make_advisor(cfg), RandomAdvisor)
    assert isinstance(make_advisor(ENAS, advisor_type="random"),
                      RandomAdvisor)
    assert isinstance(make_advisor(ENAS, device="cpu"), EnasAdvisor)
    for name, cls in (("asha", AshaAdvisor), ("pbt", PbtAdvisor)):
        assert isinstance(make_advisor(cfg, advisor_type=name), cls)
    with pytest.raises(ValueError, match="Unknown advisor type"):
        make_advisor(cfg, advisor_type="nope")
