"""The device staging cache and the per-chunk path on the card.

This test needs a CUDA device and skips without one. On a machine with a
card and without JAX, run it without the JAX test configuration:

    python -m pytest --noconftest -m cuda tests/test_torch_staging_cuda.py

A tiny ViT (its train step captured as a CUDA graph) trains with both
residency caches on, again on their hits, with both off, and on the
per-chunk path in chunks of 2 steps; all four end with the same
parameters, bit for bit. The staged entry is a uint8 and an int32
tensor on the card, and the cached host set's bytes are unchanged.
"""

import _torch_threads  # noqa: F401  (caps torch threads under xdist)

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

KNOBS = {"d_model": 32, "n_heads": 2, "patch": 4, "depth": 2,
         "learning_rate": 3e-3, "weight_decay": 1e-4, "batch_size": 32,
         "max_epochs": 2, "early_stop_epochs": 5}


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _params(model):
    return {k: np.array(v) for k, v in model.dump_parameters().items()
            if not k.startswith("_")}


def test_cached_uncached_and_per_chunk_trials_agree(card, tmp_path,
                                                    monkeypatch):
    from rafiki_torch.datasets import make_synthetic_image_dataset
    from rafiki_torch.model import dataset as mds
    from rafiki_torch.model import torch_model
    from rafiki_torch.models import TorchViT

    train, val = make_synthetic_image_dataset(
        str(tmp_path / "data"), n_train=256, n_val=64,
        image_shape=(16, 16, 3), n_classes=4, seed=0)
    mds.clear_dataset_cache()
    torch_model.clear_stage_cache()

    def trial():
        m = TorchViT(device=card, **KNOBS)
        m.train(train)
        acc = m.evaluate(val)
        return _params(m), acc

    runs = [trial(), trial()]
    ds = mds.load_image_dataset(train)
    digest = ds.images.tobytes()
    data, labels = torch_model.staged_dataset_arrays(train, ds, card)
    assert data.device.type == labels.device.type == "cuda"
    assert data.dtype == torch.uint8 and labels.dtype == torch.int32
    assert torch_model.stage_cache_info()["entries"] == 2
    monkeypatch.setenv(mds.DATASET_CACHE_ENV, "0")
    monkeypatch.setenv(torch_model.STAGE_CACHE_ENV, "0")
    runs.append(trial())
    monkeypatch.delenv(mds.DATASET_CACHE_ENV)
    monkeypatch.delenv(torch_model.STAGE_CACHE_ENV)
    monkeypatch.setenv(torch_model.STAGE_BYTES_ENV, "1")
    monkeypatch.setattr(torch_model, "CHUNK_STEPS", 2)
    runs.append(trial())
    for other in runs[1:]:
        assert other[1] == runs[0][1]
        for k in runs[0][0]:
            assert np.array_equal(other[0][k], runs[0][0][k]), k
    assert ds.images.tobytes() == digest
    mds.clear_dataset_cache()
    torch_model.clear_stage_cache()
