"""``TorchViT`` at dp 4 against the reference on 4 of its 8 virtual CPU
devices (ENAS in ``tests/test_torch_dp_enas.py``, ``tensor_parallel``
in ``tests/test_torch_dp_tp.py``).

As ``tests/test_torch_dp_zoo.py``: the same starting parameters, one
epoch (one step) at batch 16 with augmentation off, then predict and
evaluate on the reference's trained parameters, all in float32, at
d_model 128 with 4 heads on 8×8 images (5 tokens). Tolerances: the
epoch loss within 1e-5, probabilities within 1e-5, accuracies equal,
each tensor's update within 1e-2 of its size (Adam's first step flips
the sign of some elements whose gradients are near zero: measured
3.3e-3 at dp 4, and 3.0e-3 for the single-device port against the
reference on 8 devices).
"""

import _torch_threads  # noqa: F401  (caps torch threads under xdist)

import jax
import jax.numpy as jnp
import numpy as np
import torch
from flax import traverse_util

from _torch_dp import close_updates, f32_jax, zoo_step
from rafiki_torch.datasets import make_synthetic_image_dataset
from rafiki_torch.models import TorchViT, layers
from rafiki_tpu.models import JaxViT
from rafiki_tpu.models.vit import _ViT

VIT = {"d_model": 128, "n_heads": 4, "patch": 4, "depth": 2,
       "learning_rate": 3e-3, "weight_decay": 1e-2, "batch_size": 16,
       "max_epochs": 1, "early_stop_epochs": 0}
SHAPE = (8, 8, 3)


def _vit_start(seed=0):
    jm = _ViT(n_classes=10, d_model=128, n_heads=4, patch=4, n_tokens=5)
    flat = {k: np.asarray(v, np.float32) for k, v in
            traverse_util.flatten_dict(jm.init(
                jax.random.key(seed), jnp.zeros((1, *SHAPE))),
                sep="/").items()}
    rng = np.random.default_rng(seed)
    for k, v in flat.items():
        if k.endswith(("/scale", "/bias")) or k == "params/cls":
            flat[k] = (v + 0.1 * rng.standard_normal(v.shape)).astype(
                np.float32)
    return flat


def _images(tmp_path_factory, shape, n_train):
    return make_synthetic_image_dataset(
        str(tmp_path_factory.mktemp("dp_zoo2")), n_train=n_train, n_val=12,
        image_shape=shape, n_classes=10, seed=0)


def _queries(shape):
    return list(np.random.default_rng(3).integers(
        0, 256, (5, *shape)).astype(np.uint8))


def _columns(monkeypatch):
    """The list each column-parallel call of a layer fills with its tp
    shards' devices."""
    seen = []
    real = layers.column

    def column(layer, x, fn, dim=-1):
        shards = getattr(layer, "tp_shards", None)
        if shards is not None:
            seen.append([d for d, _, _ in shards])
        return real(layer, x, fn, dim)

    monkeypatch.setattr(layers, "column", column)
    return seen


def vit_step(tmp_path_factory, monkeypatch, tp):
    monkeypatch.setattr(layers, "COMPUTE", torch.float32)
    columns = _columns(monkeypatch)
    train_path, val = _images(tmp_path_factory, SHAPE, 16)
    start = _vit_start(1)
    knobs = dict(VIT, tensor_parallel=tp)
    jrec, trec, a, b, pj, pt, ej, et = zoo_step(
        f32_jax(JaxViT)(**knobs), TorchViT(device="cpu", **knobs),
        train_path, start, val, _queries(SHAPE))
    assert abs(jrec[0]["loss"] - trec[0]["loss"]) <= 1e-5
    close_updates(a, b, start, 1e-2)
    np.testing.assert_allclose(pt, pj, atol=1e-5, rtol=0)
    assert et == ej
    # Under tp 2 the QKV and first FFN layers of every block run over
    # their row's 2 tp ranks; under tp 1 nothing is split.
    assert bool(columns) == (tp == 2)
    assert all(len(c) == 2 for c in columns)


def test_vit(tmp_path_factory, monkeypatch):
    vit_step(tmp_path_factory, monkeypatch, 1)
