"""Training parity of the conv zoo: a few SGD steps of ``TorchDenseNet``
and ``TorchEnas`` against ``JaxDenseNet`` and ``JaxEnas`` on the CPU,
from the same parameters (carried by the bridge), with augmentation set
to identity on both sides, then the parameters and DenseNet's running
statistics against the reference's. The JAX side trains on the 8-device
CPU mesh of ``tests/conftest.py`` (batch 16). Sizes and helpers are
``tests/test_torch_zoo.py``'s; the tolerances are stated in the test.
"""

import _torch_threads  # noqa: F401  (caps torch threads under xdist)
import numpy as np
import pytest
import torch

from rafiki_torch.datasets import make_synthetic_image_dataset
from rafiki_torch.models import layers
from test_torch_zoo import (N_CLASSES, _bases, _densenet_pair, _enas_pair,
                            _jax_cls, _knobs_for, _torch_cls, _train,
                            jax_logger, torch_logger)
from test_torch_zoo import cifar_like  # noqa: F401  (a fixture)


@pytest.fixture(scope="module")
def small_images(tmp_path_factory):
    return make_synthetic_image_dataset(
        str(tmp_path_factory.mktemp("zoo8")), n_train=64, n_val=32,
        image_shape=(8, 8, 3), n_classes=N_CLASSES, seed=0)


@pytest.mark.parametrize("model,dtype", [
    ("densenet", "float32"), ("densenet", "bfloat16"),
    ("enas", "float32"), ("enas", "bfloat16")])
def test_training_matches_jax(cifar_like, small_images, monkeypatch, model,
                              dtype):
    """One epoch of 4 SGD steps from the same parameters, augmentation
    set to identity on both sides, then the parameters (and DenseNet's
    running statistics) against the reference's.

    In float32 (flax's ``dtype`` and the port's ``layers.COMPUTE``) the
    two take the same steps up to f32 rounding: each tensor's update
    within 1e-2 of its size (measured 8.5e-4 for ENAS, 9.5e-6 for
    DenseNet), the statistics within 1e-5. DenseNet runs this on 8×8
    images: at 32×32 its BatchNorms reduce 16,384 values a channel, and
    the reference's own f32 gradient on the CPU then strays (measured on
    one BatchNorm whose mean is 30 times its spread: 2.2e-3 from the
    float64 gradient, the port's 5.8e-5), which four steps grow to 7.6%
    of a tensor's update.

    In bf16 the gradients of these normalised networks at their start
    are sums with heavy cancellation: on one DenseNet step the
    reference's and the port's bf16 gradients each lie 33% (relative
    norm, worst tensor) from a float32 step and 22% from each other.
    There the epoch loss is held within 5e-3, the whole model's update
    (every tensor together) within 40% of its size (measured 29% and
    4.7%), and the running statistics within 1.5e-2 (measured
    5.6e-3)."""
    train = (small_images if (model, dtype) == ("densenet", "float32")
             else cifar_like)[0]
    jbase, tbase = _bases(model)
    jcls = _jax_cls(jbase, dtype, augment=False)
    tcls = _torch_cls(tbase, augment=False)
    if dtype == "float32":
        monkeypatch.setattr(layers, "COMPUTE", torch.float32)
    start = (_densenet_pair if model == "densenet" else _enas_pair)(
        seed=2)[1]
    knobs = _knobs_for(model)
    jm = jcls(**jcls.validate_knobs(knobs))
    tm = tcls(device="cpu", **tcls.validate_knobs(knobs))
    jrec = _train(jax_logger, jm, train, start)
    trec = _train(torch_logger, tm, train, start)
    assert len(jrec) == len(trec) == 1
    assert abs(jrec[0]["loss"] - trec[0]["loss"]) <= 5e-3
    a = {k: np.asarray(v) for k, v in jm.dump_parameters().items()}
    b = tm.dump_parameters()
    assert set(a) == set(b)
    params = [k for k in start if k.startswith("params/")]
    stats = [k for k in start if k.startswith("batch_stats/")]
    assert (len(stats) > 0) == (model == "densenet")
    if dtype == "float32":
        for k in params:
            step = np.linalg.norm(a[k] - start[k])
            assert step > 0, k
            assert np.linalg.norm(b[k] - a[k]) <= 1e-2 * step, k
        stats_atol = 1e-5
    else:
        da = np.concatenate([(a[k] - start[k]).ravel() for k in params])
        db = np.concatenate([(b[k] - start[k]).ravel() for k in params])
        assert np.linalg.norm(db - da) <= 0.4 * np.linalg.norm(da)
        stats_atol = 1.5e-2
    for k in stats:
        np.testing.assert_allclose(b[k], a[k], atol=stats_atol, rtol=0,
                                   err_msg=k)
