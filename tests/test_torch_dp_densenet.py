"""DenseNet's data parallelism: ``TorchDenseNet`` (``densenet_tiny``,
growth 8, 8×8 images) on a group of 4 CPU entries against the reference
on 4 of its 8 virtual devices, from the same jittered parameters and
running statistics, two train steps at batch 16 (4 rows a rank) with
augmentation off, in float32 on both sides; then predict and evaluate on
the reference's trained parameters.

The reference's BatchNorms sit in one jitted program over the global
batch, so their moments are the whole batch's; the port's must sum each
rank's per-channel sums over the ranks, or its activations and its
``batch_stats`` differ by the ranks' spread. Tolerances
(``test_torch_zoo_train.py``'s): the epoch loss within 1e-5, each
tensor's update within 1e-2 of its size, every running statistic within
1e-5 (each moved by more than 1e-3), probabilities within 1e-5,
accuracies equal.
"""

import _torch_threads  # noqa: F401  (caps torch threads under xdist)

import numpy as np
import torch

from _torch_dp import close_updates, f32_jax, zoo_step
from rafiki_torch.models import TorchDenseNet, layers
from rafiki_tpu.models import JaxDenseNet
from test_torch_dp_zoo import _data, _queries
from test_torch_zoo import GROWTH, _densenet_pair


class _NoAugDenseNet(TorchDenseNet):
    def augment_in_graph(self, x, step, row0=0):
        return x


def test_densenet_batch_statistics_are_the_whole_batch_s(tmp_path_factory,
                                                         monkeypatch):
    monkeypatch.setattr(layers, "COMPUTE", torch.float32)
    shape = (8, 8, 3)
    train_path, val = _data(tmp_path_factory, shape, 10, 32)
    start = _densenet_pair(seed=2)[1]
    knobs = {"arch": "densenet_tiny", "growth_rate": GROWTH,
             "learning_rate": 0.1, "weight_decay": 1e-4, "batch_size": 16,
             "max_epochs": 1, "early_stop_epochs": 5, "quick_train": False}
    jrec, trec, a, b, pj, pt, ej, et = zoo_step(
        f32_jax(JaxDenseNet)(**knobs), _NoAugDenseNet(device="cpu", **knobs),
        train_path, start, val, _queries(shape))
    assert abs(jrec[0]["loss"] - trec[0]["loss"]) <= 1e-5
    close_updates(a, b, start, 1e-2,
                  [k for k in start if k.startswith("params/")])
    stats = [k for k in start if k.startswith("batch_stats/")]
    assert stats
    for k in stats:
        assert np.abs(a[k] - start[k]).max() > 1e-3, k
        np.testing.assert_allclose(b[k], a[k], atol=1e-5, rtol=0,
                                   err_msg=k)
    np.testing.assert_allclose(pt, pj, atol=1e-5, rtol=0)
    assert et == ej
