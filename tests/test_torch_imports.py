"""Import discipline and device rules of the port.

``rafiki_torch`` and ``chip_smoke.py`` import neither JAX nor the JAX
package; every entry point defaults to CUDA and raises, rather than
carrying on on the CPU, when there is no card.
"""

import _torch_threads  # noqa: F401  (caps torch threads under xdist)
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
                "rafiki_torch.predictor.edge_cache",
                "rafiki_torch.constants", "rafiki_torch.model.torch_model",
                "rafiki_torch.model.dev", "rafiki_torch.models.feedforward",
                "rafiki_torch.datasets.real", "rafiki_torch.advisor",
                "rafiki_torch.advisor.random_advisor",
                "rafiki_torch.store.meta", "rafiki_torch.store.params",
                "rafiki_torch.store.tensorfile",
                "rafiki_torch.worker.runner", "rafiki_torch.bus",
                "rafiki_torch.bus.base", "rafiki_torch.bus.memory",
                "rafiki_torch.utils.auth", "rafiki_torch.utils.model_loader",
                "rafiki_torch.parallel.chips", "rafiki_torch.advisor.worker",
                "rafiki_torch.worker.train", "rafiki_torch.container",
                "rafiki_torch.container.manager",
                "rafiki_torch.container.services", "rafiki_torch.admin",
                "rafiki_torch.admin.admin", "rafiki_torch.admin.app",
                "rafiki_torch.admin.services_manager",
                "rafiki_torch.client", "rafiki_torch.client.client",
                "rafiki_torch.platform", "rafiki_torch.quickstart",
                "rafiki_torch.models.layers", "rafiki_torch.models.densenet",
                "rafiki_torch.models.enas", "rafiki_torch.advisor.bayes",
                "rafiki_torch.advisor.enas", "rafiki_torch.advisor.registry",
                "rafiki_torch.utils.hashing", "rafiki_torch.model.stacked",
                "rafiki_torch.observe.wire", "rafiki_torch.models.vit",
                "rafiki_torch.models.cnn", "rafiki_torch.models.transformer",
                "rafiki_torch.models.pos_tagger",
                "rafiki_torch.models.tabular", "rafiki_torch.model.dataset",
                "rafiki_torch.model.bridge", "rafiki_torch.config",
                "rafiki_torch.observe.metrics", "rafiki_torch.observe.serving",
                "rafiki_torch.observe.trace", "rafiki_torch.predictor.batcher",
                "rafiki_torch.predictor.predictor",
                "rafiki_torch.utils.service",
                "rafiki_torch.observe.attribution",
                "rafiki_torch.observe.workload", "rafiki_torch.__main__",
                "rafiki_torch.bus.tcp", "rafiki_torch.bus.native",
                "rafiki_torch.utils.service_logs"):
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


# Packages this sandbox has and the card's machine does not.
ABSENT_ON_THE_CARD = ("sklearn", "safetensors", "PIL")


def test_the_port_imports_without_the_packages_the_card_lacks():
    """Every port module imports with ``sklearn``, ``safetensors`` and
    ``PIL`` blocked, as on the card's machine; no port module loads
    them at import."""
    mods = list(_port_modules())
    code = (f"import importlib, importlib.abc, sys\n"
            f"class Block(importlib.abc.MetaPathFinder):\n"
            f"    def find_spec(self, name, path=None, target=None):\n"
            f"        if name.split('.')[0] in {ABSENT_ON_THE_CARD!r}:\n"
            f"            raise ImportError(f'{{name}} is blocked')\n"
            f"        return None\n"
            f"sys.meta_path.insert(0, Block())\n"
            f"for m in {mods!r}:\n"
            f"    importlib.import_module(m)\n"
            f"loaded = sorted(m for m in sys.modules\n"
            f"                if m.split('.')[0] in {ABSENT_ON_THE_CARD!r})\n"
            f"print(loaded)\n"
            f"sys.exit(1 if loaded else 0)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_env(),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


def test_the_platform_imports_without_jax_the_reference_or_requests():
    """The platform, the client and the quickstart import with ``jax``,
    ``rafiki_tpu`` and ``requests`` blocked (the card's machine has no
    ``requests``), and load none of them."""
    blocked = ("jax", "jaxlib", "rafiki_tpu", "requests")
    code = (f"import importlib, importlib.abc, sys\n"
            f"class Block(importlib.abc.MetaPathFinder):\n"
            f"    def find_spec(self, name, path=None, target=None):\n"
            f"        if name.split('.')[0] in {blocked!r}:\n"
            f"            raise ImportError(f'{{name}} is blocked')\n"
            f"        return None\n"
            f"sys.meta_path.insert(0, Block())\n"
            f"for m in ('rafiki_torch.platform', 'rafiki_torch.client',\n"
            f"          'rafiki_torch.quickstart'):\n"
            f"    importlib.import_module(m)\n"
            f"loaded = sorted(m for m in sys.modules\n"
            f"                if m.split('.')[0] in {blocked!r})\n"
            f"print(loaded)\n"
            f"sys.exit(1 if loaded else 0)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_env(),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


def test_the_process_entries_import_with_jax_sklearn_and_pil_blocked():
    """What a node's processes run (the CLI, the TCP and native brokers,
    the service entry) imports with ``jax``, ``rafiki_tpu``,
    ``requests``, ``sklearn`` and ``PIL`` blocked, and loads none."""
    blocked = ("jax", "jaxlib", "rafiki_tpu", "requests", "sklearn", "PIL")
    code = (f"import importlib, importlib.abc, sys\n"
            f"class Block(importlib.abc.MetaPathFinder):\n"
            f"    def find_spec(self, name, path=None, target=None):\n"
            f"        if name.split('.')[0] in {blocked!r}:\n"
            f"            raise ImportError(f'{{name}} is blocked')\n"
            f"        return None\n"
            f"sys.meta_path.insert(0, Block())\n"
            f"for m in ('rafiki_torch.__main__', 'rafiki_torch.bus.tcp',\n"
            f"          'rafiki_torch.bus.native',\n"
            f"          'rafiki_torch.container.services'):\n"
            f"    importlib.import_module(m)\n"
            f"loaded = sorted(m for m in sys.modules\n"
            f"                if m.split('.')[0] in {blocked!r})\n"
            f"print(loaded)\n"
            f"sys.exit(1 if loaded else 0)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_env(),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


def test_the_block_does_block():
    """The finder of the test above refuses what it names."""
    code = ("import importlib.abc, sys\n"
            "class Block(importlib.abc.MetaPathFinder):\n"
            "    def find_spec(self, name, path=None, target=None):\n"
            "        if name.split('.')[0] == 'safetensors':\n"
            "            raise ImportError('blocked')\n"
            "sys.meta_path.insert(0, Block())\n"
            "import safetensors\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_env(),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and "blocked" in out.stderr


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


@pytest.mark.parametrize("entry", ["device", "model", "worker", "app",
                                   "feedforward", "runner", "model_class",
                                   "platform", "allocator", "bus_worker",
                                   "densenet", "enas", "enas_advisor",
                                   "vit", "cnn", "tagger", "pos_tagger",
                                   "tabular"])
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
        elif entry == "feedforward":
            from rafiki_torch.models import TorchFeedForward
            TorchFeedForward(device=device)
        elif entry in ("densenet", "enas"):
            from rafiki_torch.models import TorchDenseNet, TorchEnas
            (TorchDenseNet if entry == "densenet" else TorchEnas)(
                device=device)
        elif entry in ("vit", "cnn", "tagger", "pos_tagger", "tabular"):
            from rafiki_torch import models
            {"vit": models.TorchViT, "cnn": models.TorchCnn,
             "tagger": models.TorchTransformerTagger,
             "pos_tagger": models.TorchPosTagger,
             "tabular": models.TorchTabMlpClf}[entry](device=device)
        elif entry == "enas_advisor":
            from rafiki_torch.advisor import make_advisor
            from rafiki_torch.models import TorchEnas
            make_advisor(TorchEnas.get_knob_config(), device=device)
        elif entry == "runner":
            from rafiki_torch.models import TorchFeedForward
            from rafiki_torch.store import MetaStore
            from rafiki_torch.worker import TrialRunner
            TrialRunner(TorchFeedForward, None, "t.npz", "v.npz",
                        MetaStore(":memory:"), None, "sub", device=device)
        elif entry == "model_class":
            from rafiki_torch.model import test_model_class
            from rafiki_torch.models import TorchFeedForward
            test_model_class(TorchFeedForward, "IMAGE_CLASSIFICATION",
                             "t.npz", "v.npz", device=device)
        elif entry == "worker":
            InferenceWorker(TorchTransformerLM, KNOBS, _tiny_params(),
                            device=device)
        elif entry == "platform":
            from rafiki_torch.platform import LocalPlatform
            LocalPlatform(device=device)
        elif entry == "allocator":
            from rafiki_torch.parallel import ChipAllocator
            ChipAllocator(device=device)
        elif entry == "bus_worker":
            from rafiki_torch.bus import MemoryBus
            from rafiki_torch.worker.inference import BusInferenceWorker
            BusInferenceWorker("s", "j", "t", None, None, MemoryBus(),
                               device=device)
        else:
            worker = InferenceWorker(TorchTransformerLM, KNOBS,
                                     _tiny_params(), device="cpu")
            PredictorService([worker], device=device)


def test_local_platform_without_a_device_raises_and_touches_nothing(
        tmp_path):
    """``LocalPlatform()`` means CUDA: without a card it raises before it
    makes its workdir or takes its lock."""
    if torch.cuda.is_available():
        pytest.skip("this box has a CUDA device")
    from rafiki_torch.platform import LocalPlatform

    with pytest.raises(RuntimeError, match="no CUDA device"):
        LocalPlatform(workdir=str(tmp_path / "w"), http=True)
    assert not (tmp_path / "w").exists()


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
