"""The port's platform on the card: the quickstart's whole flow
(``python -m rafiki_torch.quickstart --local --synthetic``) with
``LocalPlatform``'s default device, CUDA.

These tests need a CUDA device and skip without one. On a machine with a
card and without JAX, run them without the JAX test configuration:

    python -m pytest --noconftest -m cuda tests/test_torch_platform_cuda.py
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

pytestmark = pytest.mark.cuda

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def test_the_quickstart_runs_on_the_card(card):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run(
        [sys.executable, "-m", "rafiki_torch.quickstart", "--local",
         "--synthetic"], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=600)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "QUICKSTART OK" in out.stdout


def test_the_platform_places_its_workers_on_the_card(card, tmp_path):
    from rafiki_torch.constants import BudgetOption, TaskType, UserType
    from rafiki_torch.datasets import make_synthetic_image_dataset
    from rafiki_torch.platform import LocalPlatform

    train, val = make_synthetic_image_dataset(
        str(tmp_path / "data"), n_train=256, n_val=64,
        image_shape=(12, 12, 1), n_classes=4)
    p = LocalPlatform(workdir=str(tmp_path / "w"), supervise_interval=0)
    try:
        assert p.allocator.n_chips == torch.cuda.device_count()
        dev = p.admin.create_user("d@x.c", "pw", UserType.MODEL_DEVELOPER)
        model = p.admin.create_model(
            dev["id"], "ff", TaskType.IMAGE_CLASSIFICATION,
            "rafiki_torch.models.feedforward:TorchFeedForward")
        job = p.admin.create_train_job(
            dev["id"], "a", TaskType.IMAGE_CLASSIFICATION, [model["id"]],
            {BudgetOption.MODEL_TRIAL_COUNT: 1}, train, val)
        (svc,) = [s for s in p.meta.get_services()
                  if s["service_type"] == "TRAIN"]
        assert p.container.get(svc["id"]).device.type == "cuda"
        assert p.admin.wait_until_train_job_done(job["id"], timeout=300)
        assert p.admin.get_train_job(job["id"])["status"] == "STOPPED"
    finally:
        p.shutdown()
