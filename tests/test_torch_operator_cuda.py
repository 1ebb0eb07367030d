"""The operator and data surface on the card: a tiny image set uploaded
over HTTP, one ViT trial trained from the stored file on CUDA, and the
trial served with the packed wire off.

This test needs a CUDA device and skips without one. On a machine with a
card and without JAX, run it without the JAX test configuration:

    python -m pytest --noconftest -m cuda tests/test_torch_operator_cuda.py

The trial's steps launch K1, K2 and K3 on their wgmma variants; the
worker built under ``RAFIKI_TPU_SERVING_PACKED_WIRE=off`` offers no
packed wire and answers ``POST /predict`` with a distribution an image;
the train worker's log tail holds its trial's records.
"""

import _torch_threads  # noqa: F401  (caps torch threads under xdist)
import time

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

SHAPE = (32, 32, 3)
N_CLASSES = 10
SOURCE = """
from rafiki_torch.model import FixedKnob
from rafiki_torch.models import TorchViT


class TinyViT(TorchViT):
    @staticmethod
    def get_knob_config():
        cfg = dict(TorchViT.get_knob_config())
        cfg.update(depth=FixedKnob(2), batch_size=FixedKnob(64),
                   max_epochs=FixedKnob(2))
        return cfg
"""


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _set(path, n, seed):
    rng = np.random.default_rng(seed)
    np.savez(path, images=rng.integers(0, 256, (n,) + SHAPE, dtype=np.uint8),
             labels=rng.integers(0, N_CLASSES, n), n_classes=N_CLASSES)
    return path


def test_an_uploaded_set_trains_and_serves_with_the_wire_off(
        card, tmp_path, monkeypatch):
    from rafiki_torch.cache import Cache
    from rafiki_torch.client import Client
    from rafiki_torch.constants import BudgetOption, TaskType
    from rafiki_torch.observe import wire
    from rafiki_torch.ops import attention as attn
    from rafiki_torch.platform import LocalPlatform

    monkeypatch.setenv(wire.PACKED_WIRE_ENV, "off")
    wire.reset_for_tests()
    plat = LocalPlatform(workdir=str(tmp_path / "node"), http=True,
                         supervise_interval=0)
    try:
        client = Client(admin_port=plat.admin_port)
        client.login("superadmin@rafiki", "rafiki")
        up = {n: client.create_dataset(
            f"tiny-{n}", TaskType.IMAGE_CLASSIFICATION,
            _set(str(tmp_path / f"{n}.npz"), size, seed))
            for n, size, seed in (("train", 512, 0), ("val", 128, 1))}
        assert [d["name"] for d in client.get_datasets()] == \
            ["tiny-train", "tiny-val"]
        model = client.create_model("tiny-vit", TaskType.IMAGE_CLASSIFICATION,
                                    "TinyViT", model_source=SOURCE)
        k = [attn.flash_attention, attn.flash_attention_dq,
             attn.flash_attention_dkv]
        before = [(f.launches, f.variant_launches["wgmma"]) for f in k]
        job = client.create_train_job(
            "tiny", TaskType.IMAGE_CLASSIFICATION, [model["id"]],
            {BudgetOption.MODEL_TRIAL_COUNT: 1}, up["train"]["path"],
            up["val"]["path"], advisor_type="random")
        done = client.wait_until_train_job_done(job["id"], timeout=600,
                                                poll=0.2)
        assert done["status"] == "STOPPED"
        (trial,) = client.get_trials_of_train_job(job["id"])
        assert trial["status"] == "COMPLETED"
        for f, (n, w) in zip(k, before):
            assert f.launches > n
            assert f.variant_launches["wgmma"] - w == f.launches - n
        records = [r["record"] for r in client.get_trial_logs(trial["id"])]
        assert any(r.get("type") == "plot" and
                   r["plot"]["title"] == "Training" for r in records)
        assert sum(1 for r in records if "loss" in r.get("values", {})) == 2
        (train_svc,) = [s for s in client.get_services()
                        if s["service_type"] == "TRAIN"]
        tail = client.get_service_logs(train_svc["id"])
        assert tail["captured"] and "trial" in tail["log"]

        inf = client.create_inference_job(job["id"], max_models=1)
        cache = Cache(plat.bus)
        deadline = time.monotonic() + 120
        while not cache.running_workers(inf["id"]):
            assert time.monotonic() < deadline, "no worker registered"
            time.sleep(0.05)
        (info,) = cache.running_worker_info(inf["id"]).values()
        assert info["wire"] == []
        host = client.get_inference_job(inf["id"])["predictor_host"]
        rng = np.random.default_rng(2)
        imgs = rng.integers(0, 256, (4,) + SHAPE, dtype=np.uint8)
        preds = client.predict(host, queries=list(imgs))["predictions"]
        probs = np.asarray(preds, np.float64)
        assert probs.shape == (4, N_CLASSES) and np.isfinite(probs).all()
        assert np.abs(probs.sum(axis=1) - 1.0).max() < 1e-4
        assert not wire.counting()
        client.stop_inference_job(inf["id"])
    finally:
        plat.shutdown()
        wire.reset_for_tests()
