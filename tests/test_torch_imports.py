"""Import discipline and device rules of the port.

``rafiki_torch`` and ``chip_smoke.py`` import neither JAX nor the JAX
package; every entry point defaults to CUDA and raises, rather than
carrying on on the CPU, when there is no card.
"""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "rafiki_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "rafiki_tpu")


def _port_modules():
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(ROOT).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        yield ".".join(parts)


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    return env


def test_importing_the_port_loads_no_jax():
    mods = list(_port_modules())
    for mod in ("rafiki_torch.models.lm", "rafiki_torch.ops.attention",
                "rafiki_torch.model.optim", "rafiki_torch.model.logger",
                "rafiki_torch.model.loop_ckpt", "rafiki_torch.observe",
                "rafiki_torch.observe.profiling", "rafiki_torch.datasets.synth",
                "rafiki_torch.models.lm_generate",
                "rafiki_torch.worker.decode_scheduler",
                "rafiki_torch.predictor.app", "rafiki_torch.cache",
                "rafiki_torch.predictor.edge_cache"):
        assert mod in mods, mod
    code = (f"import importlib, sys\n"
            f"for m in {mods!r}:\n"
            f"    importlib.import_module(m)\n"
            f"bad = sorted(m for m in sys.modules\n"
            f"             if m.split('.')[0] in {FORBIDDEN!r})\n"
            f"print(bad)\n"
            f"sys.exit(1 if bad else 0)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_env(),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


@pytest.mark.parametrize("path", sorted(
    [str(p.relative_to(ROOT)) for p in PORT.rglob("*.py")]
    + ["chip_smoke.py"]))
def test_no_file_imports_jax_or_the_reference(path):
    tree = ast.parse((ROOT / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, (path, name)


def _tiny_params(d=256, L=2, V=512):
    rng = np.random.default_rng(0)
    p = {"embed": rng.standard_normal((V, d)), "lnf": np.ones(d),
         "layers/ln1": np.ones((L, d)), "layers/ln2": np.ones((L, d)),
         "layers/qkv": rng.standard_normal((L, d, 3 * d)),
         "layers/proj": rng.standard_normal((L, d, d)),
         "layers/w1": rng.standard_normal((L, d, 4 * d)),
         "layers/w2": rng.standard_normal((L, 4 * d, d))}
    return {k: v.astype(np.float32) for k, v in p.items()}


KNOBS = {"d_model": 256, "n_layers": 2, "seq_len": 256, "batch_size": 4,
         "learning_rate": 1e-2, "train_steps": 200, "vocab_size": 512,
         "quick_train": False}


@pytest.mark.parametrize("entry", ["device", "model", "worker", "app"])
@pytest.mark.parametrize("device", [None, "cuda"])
def test_entry_points_raise_without_a_card(entry, device):
    if torch.cuda.is_available():
        pytest.skip("this box has a CUDA device")
    from rafiki_torch.models import TorchTransformerLM
    from rafiki_torch.predictor import PredictorService
    from rafiki_torch.torchenv import resolve_device
    from rafiki_torch.worker import InferenceWorker

    with pytest.raises(RuntimeError, match="no CUDA device"):
        if entry == "device":
            resolve_device(device)
        elif entry == "model":
            TorchTransformerLM(device=device, **KNOBS)
        elif entry == "worker":
            InferenceWorker(TorchTransformerLM, KNOBS, _tiny_params(),
                            device=device)
        else:
            worker = InferenceWorker(TorchTransformerLM, KNOBS,
                                     _tiny_params(), device="cpu")
            PredictorService([worker], device=device)


def test_cpu_is_used_only_when_asked():
    from rafiki_torch.torchenv import resolve_device

    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_flash_attention_takes_the_plain_path_only_on_the_cpu():
    """A tensor on any device but the CPU goes to the kernel or raises:
    here a meta tensor, which no kernel takes, raises."""
    from rafiki_torch.ops import flash_attention

    q = torch.zeros(1, 1, 4, 8, device="meta")
    with pytest.raises(ValueError, match="device"):
        flash_attention(q, q, q)


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_fails_without_a_card(where, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this box has a CUDA device")
    cwd = ROOT
    env = _env()
    if where == "alone":
        shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
        cwd = tmp_path
        env = dict(os.environ)
        env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
