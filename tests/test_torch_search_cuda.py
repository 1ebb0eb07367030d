"""A successive-halving rung resumed on the card against uninterrupted
card runs.

This test needs a CUDA device and skips without one. On a machine with a
card and without JAX, run it without the JAX test configuration:

    python -m pytest --noconftest -m cuda tests/test_torch_search_cuda.py

A tiny ViT trains 1 epoch with its final state checkpointed, then its
2-epoch rung resumes that state, both under a 2-epoch schedule; the
resumed run's parameters must lie no further from an uninterrupted
2-epoch run than a second uninterrupted run does (the card's own
run-to-run spread, which may be 0). The resumed run copies the saved
state into the tensors its captured train step reads: the parameters,
the fused Adam's moments and step, the schedule's device count and the
step counter the augmentation hashes.
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


def _dist(a, b):
    return max(float(np.abs(a[k] - b[k]).max()) for k in a)


def test_a_resumed_rung_is_within_the_cards_spread(card, tmp_path):
    from rafiki_torch.datasets import make_synthetic_image_dataset
    from rafiki_torch.models import TorchViT
    from rafiki_torch.ops import attention as attn

    train, _ = make_synthetic_image_dataset(
        str(tmp_path / "data"), n_train=256, n_val=32,
        image_shape=(16, 16, 3), n_classes=4, seed=0)
    runs = []
    for _ in range(2):
        m = TorchViT(device=card, **KNOBS)
        m.train(train, schedule_total_epochs=2)
        runs.append(_params(m))
    spread = _dist(runs[0], runs[1])
    ck = str(tmp_path / "ck")
    first = TorchViT(device=card, **dict(KNOBS, max_epochs=1))
    first.train(train, checkpoint_dir=ck, checkpoint_final_epoch=True,
                schedule_total_epochs=2)
    wg0 = attn.flash_attention_dq.variant_launches["wgmma"]
    rung = TorchViT(device=card, **KNOBS)
    rung.train(train, checkpoint_dir=ck, checkpoint_final_epoch=True,
               schedule_total_epochs=2)
    assert attn.flash_attention_dq.variant_launches["wgmma"] > wg0
    resumed = _params(rung)
    assert _dist(resumed, runs[0]) <= spread
    # The first rung alone is somewhere else: the resume trained.
    assert _dist(_params(first), runs[0]) > spread
