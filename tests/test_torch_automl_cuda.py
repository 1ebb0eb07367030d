"""TorchFeedForward's training on the card: the train step captured as a
CUDA graph against the same steps run eagerly, and against the CPU.

These tests need a CUDA device and skip without one. On a machine with a
card and without JAX, run them without the JAX test configuration:

    python -m pytest --noconftest -m cuda tests/test_torch_automl_cuda.py

The graph replays the kernels the eager step launches, on the same
buffers, with the lr read on the device from the same f32 values, so the
trained parameters must be the same bits. Against the CPU, the card's
cuBLAS sums the bf16 products in another order: the tolerances of
``tests/test_torch_feedforward.py``'s training parity over one epoch of
about as many steps (epoch loss within 5e-3, each parameter's update
within 10% of its size).
"""

import _torch_threads  # noqa: F401  (caps torch threads under xdist)
import numpy as np
import pytest
import torch

from rafiki_torch.datasets import make_synthetic_image_dataset
from rafiki_torch.model import FixedKnob, torch_model
from rafiki_torch.model.logger import logger
from rafiki_torch.models import TorchFeedForward

pytestmark = pytest.mark.cuda

SHAPE = (12, 12, 1)
KNOBS = {"hidden_layer_count": 3, "hidden_layer_units": 100,
         "learning_rate": 3e-3, "batch_size": 32, "max_epochs": 5}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture
def data(tmp_path):
    return make_synthetic_image_dataset(str(tmp_path), n_train=320,
                                        n_val=64, image_shape=SHAPE,
                                        n_classes=4)


def _params(seed=5):
    rng = np.random.default_rng(seed)
    widths = [int(np.prod(SHAPE)), 128, 128, 128, 4]
    p = {}
    for i in range(4):
        p[f"params/Dense_{i}/kernel"] = (
            rng.standard_normal((widths[i], widths[i + 1]))
            / np.sqrt(widths[i])).astype(np.float32)
        p[f"params/Dense_{i}/bias"] = (
            0.1 * rng.standard_normal(widths[i + 1])).astype(np.float32)
    return p


class OneEpoch(TorchFeedForward):
    @staticmethod
    def get_knob_config():
        cfg = dict(TorchFeedForward.get_knob_config())
        cfg["max_epochs"] = FixedKnob(1)
        return cfg


def _train(device, train, monkeypatch, warmup, cls=TorchFeedForward):
    monkeypatch.setattr(torch_model, "WARMUP_STEPS", warmup)
    recs = []
    prior = logger.current_sink()
    logger.set_sink(recs.append)
    knobs = {k: v for k, v in KNOBS.items() if k in cls.get_knob_config()
             and not (k == "max_epochs" and cls is OneEpoch)}
    try:
        m = cls(device=device, **cls.validate_knobs(knobs))
        m.train(train, shared_params=_params())
    finally:
        logger.set_sink(prior)
    losses = [r["values"]["loss"] for r in recs if r["type"] == "values"
              and "epoch" in r["values"]]
    return m, losses


def test_captured_steps_match_eager_steps(card, data, monkeypatch):
    train, val = data
    graph, g_losses = _train(card, train, monkeypatch, warmup=3)
    eager, e_losses = _train(card, train, monkeypatch, warmup=10 ** 9)
    assert len(g_losses) == 5
    assert g_losses == e_losses
    a, b = graph.dump_parameters(), eager.dump_parameters()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert graph.evaluate(val) == eager.evaluate(val)


def test_card_training_matches_the_cpu(card, data, monkeypatch):
    """One epoch of 10 steps, 7 of them graph replays."""
    train, _ = data
    on_card, c_losses = _train(card, train, monkeypatch, 3, OneEpoch)
    on_cpu, h_losses = _train("cpu", train, monkeypatch, 3, OneEpoch)
    assert abs(c_losses[0] - h_losses[0]) <= 5e-3
    a, b, start = on_card.dump_parameters(), on_cpu.dump_parameters(), \
        _params()
    for k in start:
        step = np.linalg.norm(b[k] - start[k])
        assert np.linalg.norm(a[k] - b[k]) <= 0.10 * step, k
