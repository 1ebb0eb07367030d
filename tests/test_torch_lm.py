"""TorchTransformerLM (the port) against JaxTransformerLM on the CPU.

Both load the same seeded numpy parameters (at the TINY shape of
``tests/test_lm.py``) through ``load_parameters``; the JAX side runs its
flash kernel in interpret mode, the port its plain attention path.

Tolerances: both run a bf16 residual stream and bf16 matmuls, which round
at different places in the two frameworks, so logits may differ by about
two bf16 ulps at their magnitude (atol 3e-2) and the mean log-prob scores
by 1e-2. Accuracy may flip on argmax near-ties: at most 4 of the 4096
scored positions.
"""

import numpy as np
import pytest
import torch

from rafiki_tpu.models import JaxTransformerLM
from rafiki_torch.model.bridge import lm_from_jax, lm_to_jax
from rafiki_torch.model.dataset import write_token_dataset
from rafiki_torch.models import TorchTransformerLM

TINY = {"d_model": 256, "n_layers": 2, "seq_len": 256, "batch_size": 4,
        "learning_rate": 1e-2, "train_steps": 200, "vocab_size": 512,
        "quick_train": False}


def _params(seed=0, d=256, L=2, V=512):
    rng = np.random.default_rng(seed)
    p = {"embed": 0.02 * rng.standard_normal((V, d)),
         "lnf": 1 + 0.1 * rng.standard_normal(d)}
    for name, shape in {"qkv": (L, d, 3 * d), "proj": (L, d, d),
                        "w1": (L, d, 4 * d), "w2": (L, 4 * d, d)}.items():
        p[f"layers/{name}"] = rng.standard_normal(shape) / np.sqrt(shape[-2])
    for name in ("ln1", "ln2"):
        p[f"layers/{name}"] = 1 + 0.1 * rng.standard_normal((L, d))
    return {k: v.astype(np.float32) for k, v in p.items()}


@pytest.fixture(scope="module")
def models():
    p = _params()
    jm = JaxTransformerLM(**JaxTransformerLM.validate_knobs(TINY))
    jm.load_parameters(p)
    tm = TorchTransformerLM(device="cpu",
                            **TorchTransformerLM.validate_knobs(TINY))
    tm.load_parameters(p)
    yield jm, tm
    jm.destroy()
    tm.destroy()


def test_predict_matches_jax(models):
    jm, tm = models
    rng = np.random.default_rng(1)
    queries = [rng.integers(0, 512, 100).tolist(),   # short
               [7],                                  # one id: scores 0.0
               rng.integers(0, 512, 400).tolist(),   # over seq_len + 1
               [3, 4],                               # the shortest scored
               []]
    ref, out = jm.predict(queries), tm.predict(queries)
    assert out[1] == 0.0 and out[4] == 0.0
    assert all(isinstance(x, float) for x in out)
    np.testing.assert_allclose(out, ref, atol=1e-2, rtol=0)


def test_forward_logits_match_jax(models):
    import jax.numpy as jnp

    jm, tm = models
    ids = np.random.default_rng(2).integers(0, 512, (2, 256))
    ref = np.asarray(jm._forward(jm._params, jnp.asarray(ids, jnp.int32)))
    out = tm._forward(torch.from_numpy(ids)).numpy()
    assert out.shape == (2, 256, 512) and out.dtype == np.float32
    np.testing.assert_allclose(out, ref, atol=3e-2, rtol=0)


def test_evaluate_matches_jax(models, tmp_path):
    """The port writes the token dataset; both packages read it."""
    jm, tm = models
    ids = np.random.default_rng(3).integers(0, 512, 5000)
    path = write_token_dataset(ids, 512, str(tmp_path / "val"))
    assert abs(tm.evaluate(path) - jm.evaluate(path)) <= 4 / 4096


def test_bridge_round_trip_is_exact():
    p = _params(seed=4)
    back = lm_to_jax(lm_from_jax(p))
    assert set(back) == set(p)
    for k in p:
        assert back[k].dtype == np.float32
        np.testing.assert_array_equal(back[k], p[k])


def test_dump_parameters_round_trips(models):
    _, tm = models
    p = _params()
    dumped = tm.dump_parameters()
    assert set(dumped) == set(p)
    for k in p:
        np.testing.assert_array_equal(dumped[k], p[k])


def test_bridge_uses_torch_linear_layout():
    p = _params(seed=5)
    state = lm_from_jax(p)
    assert state["blocks.1.qkv.weight"].shape == (3 * 256, 256)
    np.testing.assert_array_equal(state["blocks.1.w2.weight"].numpy(),
                                  p["layers/w2"][1].T)


def test_predict_before_load_raises():
    tm = TorchTransformerLM(device="cpu",
                            **TorchTransformerLM.validate_knobs(TINY))
    with pytest.raises(RuntimeError, match="load_parameters"):
        tm.predict([[1, 2, 3]])
