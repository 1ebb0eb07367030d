"""``TorchEnas`` at dp 4 against the reference on 4 of its 8 virtual CPU
devices: the single path of a final trial (``TinyEnas``, 3 cells of 8
channels, an architecture fixed by the knob) warm-started from the
reference's supernet parameters (the leaves the single path has), one
epoch of 2 steps at batch 16 on 16×16 images with augmentation off, in
float32; then predict and evaluate on the reference's trained
parameters. Tolerances: ``tests/test_torch_zoo_train.py``'s, the loss
within 1e-5, each moved tensor's update within 1e-2 of its size;
probabilities within 1e-5, accuracies equal. (The supernet compiles for
about 20 s on the reference's 4-device mesh; the single path covers the
same layers.)
"""

import _torch_threads  # noqa: F401  (caps torch threads under xdist)

import numpy as np
import torch

from _torch_dp import close_updates, f32_jax, zoo_step
from rafiki_torch.datasets import make_synthetic_image_dataset
from rafiki_torch.models import TorchEnas, layers
from test_torch_dp_zoo import _queries
from test_torch_zoo import JaxTinyEnas, _enas_pair, _knobs_for


class _TorchTinyEnas(TorchEnas):
    n_blocks = 2
    full_cells, full_channels = 3, 8
    search_cells, search_channels = 3, 8

    def augment_in_graph(self, x, step, row0=0):
        return x



def test_enas(tmp_path_factory, monkeypatch):
    monkeypatch.setattr(layers, "COMPUTE", torch.float32)
    train_path, val = make_synthetic_image_dataset(
        str(tmp_path_factory.mktemp("dp_enas")), n_train=32, n_val=12,
        image_shape=(16, 16, 3), n_classes=10, seed=0)
    start = _enas_pair(seed=2)[1]
    knobs = dict(_knobs_for("enas"), batch_size=16, max_epochs=1,
                 share_params=False, quick_train=False)
    jrec, trec, a, b, pj, pt, ej, et = zoo_step(
        f32_jax(JaxTinyEnas)(**knobs),
        _TorchTinyEnas(device="cpu", **knobs), train_path, start, val,
        _queries((16, 16, 3)))
    assert abs(jrec[0]["loss"] - trec[0]["loss"]) <= 1e-5
    moved = [k for k in start if k in a and np.linalg.norm(a[k] - start[k])]
    assert len(moved) > 10
    close_updates(a, b, start, 1e-2, moved)
    np.testing.assert_allclose(pt, pj, atol=1e-5, rtol=0)
    assert et == ej
