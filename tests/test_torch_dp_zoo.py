"""The image zoo's data parallelism: ``TorchFeedForward`` and
``TorchCnn`` on a group of 4 CPU entries against the reference on 4 of
its 8 virtual devices (DenseNet, ViT, ENAS and ``tensor_parallel`` in
``tests/test_torch_dp_{densenet,zoo2,enas,tp}.py``).

Both start from the same parameters (the reference's, carried by the
bridge) and take one epoch of train steps at batch 16, 4 rows a rank;
augmentation is the identity on both sides (their draws differ). Then
both answer 5 queries (a bucket of 8, 2 rows a rank) and evaluate the
validation set on the same parameters, the reference's trained ones.

Tolerances. The CNN computes in float32 on both sides (flax's
``dtype``, the port's ``layers.COMPUTE``): the epoch loss within 1e-5,
each tensor's update within 1e-3 of its size for its one step,
probabilities within 1e-5, accuracies equal. FeedForward computes in
bf16 on both sides
(``test_torch_feedforward.py``'s tolerances): the loss within 5e-3,
each update within 10% of its size, probabilities within 3.9e-3.
"""

import _torch_threads  # noqa: F401  (caps torch threads under xdist)

import numpy as np
import pytest
import torch

from _torch_dp import close_updates, f32_jax, zoo_step
from rafiki_torch.datasets import make_synthetic_image_dataset
from rafiki_torch.models import TorchCnn, TorchFeedForward, layers
from rafiki_tpu.models import JaxCnn, JaxFeedForward
from test_torch_cnn import _init as cnn_init
from test_torch_feedforward import _params as ff_params


def _data(tmp_path_factory, shape, n_classes, n_train):
    return make_synthetic_image_dataset(
        str(tmp_path_factory.mktemp("dp_zoo")), n_train=n_train, n_val=12,
        image_shape=shape, n_classes=n_classes, seed=0)


def _queries(shape):
    return list(np.random.default_rng(3).integers(
        0, 256, (5, *shape)).astype(np.uint8))


def test_feedforward(tmp_path_factory):
    shape = (12, 12, 1)
    train_path, val = _data(tmp_path_factory, shape, 4, 32)
    start = {k: v for k, v in ff_params(seed=5).items()
             if not k.startswith("_")}
    knobs = {"hidden_layer_count": 2, "hidden_layer_units": 100,
             "learning_rate": 3e-3, "batch_size": 16, "max_epochs": 1}
    jrec, trec, a, b, pj, pt, ej, et = zoo_step(
        JaxFeedForward(**knobs), TorchFeedForward(device="cpu", **knobs),
        train_path, start, val, _queries(shape))
    assert abs(jrec[0]["loss"] - trec[0]["loss"]) <= 5e-3
    # Dense_2 is the third hidden layer, which the count mask skips.
    close_updates(a, b, start, 0.10,
                  [k for k in start if "Dense_2" not in k])
    np.testing.assert_allclose(pt, pj, atol=3.9e-3, rtol=0)
    assert et == ej


def test_cnn(tmp_path_factory, monkeypatch):
    monkeypatch.setattr(layers, "COMPUTE", torch.float32)
    shape = (16, 16, 3)
    train_path, val = _data(tmp_path_factory, shape, 10, 16)
    start = cnn_init(1)
    knobs = {"width_16ths": 12, "learning_rate": 3e-3, "weight_decay": 1e-2,
             "batch_size": 16, "max_epochs": 1, "early_stop_epochs": 0}
    jrec, trec, a, b, pj, pt, ej, et = zoo_step(
        f32_jax(JaxCnn)(**knobs), TorchCnn(device="cpu", **knobs), train_path,
        start, val, _queries(shape))
    assert abs(jrec[0]["loss"] - trec[0]["loss"]) <= 1e-5
    close_updates(a, b, start, 1e-3)
    np.testing.assert_allclose(pt, pj, atol=1e-5, rtol=0)
    assert et == ej


@pytest.mark.parametrize("tp", [3, 8])
def test_a_tensor_parallel_that_does_not_divide_the_group_raises(tp):
    from _torch_dp import bound

    with bound():
        for model in (JaxFeedForward(tensor_parallel=tp),
                      TorchFeedForward(device="cpu", tensor_parallel=tp)):
            with pytest.raises(ValueError, match="not divisible by"):
                model.mesh
