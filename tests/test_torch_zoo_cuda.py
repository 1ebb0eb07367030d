"""The conv zoo's training on the card: the train step captured as a
CUDA graph against the same steps run eagerly, the augmentation's draws
at each replay, and the card against the CPU.

These tests need a CUDA device and skip without one. On a machine with a
card and without JAX, run them without the JAX test configuration:

    python -m pytest --noconftest -m cuda tests/test_torch_zoo_cuda.py

The graph replays the kernels the eager step launches, on the same
buffers, with the lr read on the device and the crops drawn from a hash
of the device step counter, so the trained parameters and BatchNorm
statistics must be the same bits. Against the CPU, cuDNN sums the bf16
products in another order: the predictions on the same parameters
within 3.9e-3 (one bf16 ulp of a logit below 4, as
``tests/test_torch_zoo.py`` holds the port against the reference), and
one epoch's loss within 2e-2.
"""

import _torch_threads  # noqa: F401  (caps torch threads under xdist)
import numpy as np
import pytest
import torch

from rafiki_torch.datasets import make_synthetic_image_dataset
from rafiki_torch.model import FixedKnob, torch_model
from rafiki_torch.model.logger import logger
from rafiki_torch.model.torch_model import crop_flip, crop_flip_draw
from rafiki_torch.models import TorchDenseNet, TorchEnas

pytestmark = pytest.mark.cuda

SHAPE = (32, 32, 3)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture
def data(tmp_path):
    return make_synthetic_image_dataset(str(tmp_path), n_train=256,
                                        n_val=64, image_shape=SHAPE,
                                        n_classes=10)


class TinyDenseNet(TorchDenseNet):
    @staticmethod
    def get_knob_config():
        cfg = dict(TorchDenseNet.get_knob_config())
        cfg.update(batch_size=FixedKnob(32), max_epochs=FixedKnob(2))
        return cfg


class TinyEnas(TorchEnas):
    n_blocks = 2
    full_cells, full_channels = 3, 8
    search_cells, search_channels = 3, 8

    @classmethod
    def get_knob_config(cls):
        cfg = super().get_knob_config()
        cfg.update(batch_size=FixedKnob(32), max_epochs=FixedKnob(2))
        return cfg


def _knobs(model):
    if model == "densenet":
        return TinyDenseNet, {"arch": "densenet_tiny", "growth_rate": 8,
                              "learning_rate": 0.1, "weight_decay": 1e-4,
                              "early_stop_epochs": 5, "quick_train": False}
    arch = np.random.default_rng(3).integers(0, 2, 16).tolist()
    return TinyEnas, {"arch": arch, "learning_rate": 0.05,
                      "trial_epochs": 1, "share_params": True,
                      "quick_train": False, "downscale": True}


def _train(device, train, monkeypatch, warmup, model):
    monkeypatch.setattr(torch_model, "WARMUP_STEPS", warmup)
    cls, knobs = _knobs(model)
    recs = []
    prior = logger.current_sink()
    logger.set_sink(recs.append)
    try:
        m = cls(device=device, **cls.validate_knobs(knobs))
        m.train(train)
    finally:
        logger.set_sink(prior)
    losses = [r["values"]["loss"] for r in recs if r["type"] == "values"
              and "epoch" in r["values"]]
    return m, losses


@pytest.mark.parametrize("model", ["densenet", "enas"])
def test_captured_steps_match_eager_steps(card, data, monkeypatch, model):
    """Two epochs of 8 steps, 13 of them graph replays."""
    train, val = data
    graph, g_losses = _train(card, train, monkeypatch, 3, model)
    eager, e_losses = _train(card, train, monkeypatch, 10 ** 9, model)
    assert len(g_losses) == 2 and g_losses == e_losses
    a, b = graph.dump_parameters(), eager.dump_parameters()
    assert any(k.startswith("batch_stats/") for k in a) == (
        model == "densenet")
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert graph.evaluate(val) == eager.evaluate(val)


def test_replays_draw_new_crops(card):
    """A captured augmentation draws anew at every replay, as the eager
    calls at the same steps draw."""
    x = torch.rand(64, *SHAPE, device=card)
    step = torch.zeros((), dtype=torch.int64, device=card)
    out = torch.empty_like(x)

    def aug():
        ys, xs, flip = crop_flip_draw(7, step, 64)
        out.copy_(crop_flip(x, ys, xs, flip))
        step.add_(1)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        aug()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        aug()
    step.fill_(5)
    g.replay()
    first = out.clone()
    g.replay()
    second = out.clone()
    assert not torch.equal(first, second)
    for at, got in ((5, first), (6, second)):
        ys, xs, flip = crop_flip_draw(7, torch.tensor(at, device=card), 64)
        assert torch.equal(got, crop_flip(x, ys, xs, flip))


@pytest.mark.parametrize("model", ["densenet", "enas"])
def test_card_matches_the_cpu(card, data, monkeypatch, model):
    train, val = data
    on_card, c_losses = _train(card, train, monkeypatch, 3, model)
    on_cpu, h_losses = _train("cpu", train, monkeypatch, 3, model)
    assert abs(c_losses[0] - h_losses[0]) <= 2e-2
    cls, knobs = _knobs(model)
    params = on_card.dump_parameters()
    there = cls(device=card, **cls.validate_knobs(knobs))
    here = cls(device="cpu", **cls.validate_knobs(knobs))
    there.load_parameters(params)
    here.load_parameters(params)
    imgs = np.random.default_rng(0).integers(0, 256, (16, *SHAPE),
                                             dtype=np.uint8)
    np.testing.assert_allclose(there.predict_proba(imgs),
                               here.predict_proba(imgs), atol=3.9e-3,
                               rtol=0)
