"""The CNN over ``tensor_parallel`` 2 on a group of 4 entries (dp 2 ×
tp 2) against the reference on 4 of its 8 virtual CPU devices: its
Conv_4, Conv_5 and Dense_0 kernels (256 output features) split over the
tp ranks (``tests/test_torch_dp_tp.py`` lists them against the
reference's ``variables_shardings``), and each of those layers computes
its tp ranks' output slices on their devices (``layers.column``), which
the test counts.

Both start from the same parameters (the reference's, carried by the
bridge) and take one train step at batch 16, 8 rows a dp rank, in
float32 (flax's ``dtype``, the port's ``layers.COMPUTE``) without
augmentation; then both answer 5 queries and evaluate the validation
set on the reference's trained parameters. Tolerances, those of
``tests/test_torch_dp_zoo.py``'s CNN at dp 4: the epoch loss within
1e-5, each tensor's update within 1e-3 of its size, probabilities within
1e-5, accuracies equal.
"""

import _torch_threads  # noqa: F401  (caps torch threads under xdist)

import numpy as np
import torch

from _torch_dp import close_updates, f32_jax, zoo_step
from rafiki_torch.models import TorchCnn, layers
from rafiki_tpu.models import JaxCnn
from test_torch_cnn import _init as cnn_init
from test_torch_dp_tp import _count_columns
from test_torch_dp_zoo import _data, _queries


def test_cnn_over_dp_2_and_tp_2(tmp_path_factory, monkeypatch):
    monkeypatch.setattr(layers, "COMPUTE", torch.float32)
    shape = (16, 16, 3)
    train_path, val = _data(tmp_path_factory, shape, 10, 16)
    start = cnn_init(1)
    knobs = {"width_16ths": 12, "learning_rate": 3e-3, "weight_decay": 1e-2,
             "batch_size": 16, "max_epochs": 1, "early_stop_epochs": 0,
             "tensor_parallel": 2}
    calls = _count_columns(monkeypatch)
    jrec, trec, a, b, pj, pt, ej, et = zoo_step(
        f32_jax(JaxCnn)(**knobs), TorchCnn(device="cpu", **knobs),
        train_path, start, val, _queries(shape))
    # Conv_4, Conv_5 and Dense_0 of each of 2 dp ranks in the one step,
    # then in the predict's and the evaluation's forwards.
    assert len(calls) > 3 * 2 and set(calls) == {2}
    assert abs(jrec[0]["loss"] - trec[0]["loss"]) <= 1e-5
    close_updates(a, b, start, 1e-3)
    np.testing.assert_allclose(pt, pj, atol=1e-5, rtol=0)
    assert et == ej
