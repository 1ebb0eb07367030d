"""The port's static-analysis CLI, ``python -m rafiki_torch.analysis``,
run in a fresh interpreter that cannot import torch, triton, numpy,
jax or the reference: ``--json`` on the real tree, ``--explain``,
``--diff`` and the refusals of a partial ``--update-baseline``. The
counterparts of the CLI tests of ``tests/test_analysis.py``.
"""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: Run the CLI in a fresh interpreter that cannot import these.
BLOCKED = ("torch", "triton", "numpy", "rafiki_tpu", "jax")
BLOCKING_CLI = (
    "import importlib.abc, runpy, sys\n"
    "class Block(importlib.abc.MetaPathFinder):\n"
    "    def find_spec(self, name, path=None, target=None):\n"
    f"        if name.split('.')[0] in {BLOCKED!r}:\n"
    "            raise ImportError(name + ' is blocked')\n"
    "        return None\n"
    "sys.meta_path.insert(0, Block())\n"
    "sys.argv = ['rafiki_torch.analysis'] + sys.argv[1:]\n"
    "try:\n"
    "    runpy.run_module('rafiki_torch.analysis', run_name='__main__')\n"
    "finally:\n"
    "    loaded = [m for m in sys.modules\n"
    f"              if m.split('.')[0] in {BLOCKED!r}]\n"
    "    assert not loaded, loaded\n")


def _cli(*args, timeout=240):
    return subprocess.run(
        [sys.executable, "-c", BLOCKING_CLI, *args], capture_output=True,
        text=True, timeout=timeout, cwd=REPO)


def test_cli_json_exits_zero_with_torch_blocked():
    proc = _cli("--json")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    data = json.loads(proc.stdout)
    assert data["new"] == 0
    assert data["files"] > 100
    assert data["root"] == REPO
    assert all(k.startswith("RTA") for k in data["counts_per_code"])
    # Explicit zeros: the aliasing checker looked.
    assert data["counts_per_code"]["RTA401"] == 0
    assert set(data["by_status"]) == {"waived", "baselined"}


def test_cli_explain():
    proc = _cli("--explain", "RTA401", timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "F7" in proc.stdout and "from_numpy" in proc.stdout
    assert "fix   :" in proc.stdout
    proc = _cli("--explain", "RTA999", timeout=120)
    assert proc.returncode == 2
    assert "unknown code" in proc.stderr


def test_diff_mode_cli_and_timings(tmp_path):
    proc = _cli("--diff", "HEAD")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "timings:" in proc.stderr
    proc = _cli("--json", "--checker", "aliasing")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "aliasing" in json.loads(proc.stdout)["timings_s"]
    proc = _cli("--changed", "--diff", "HEAD", timeout=60)
    assert proc.returncode == 2
    proc = _cli("--diff", "HEAD", "--update-baseline", "--baseline",
                str(tmp_path / "bl.json"), timeout=120)
    assert proc.returncode == 2
    assert "requires a full run" in proc.stderr
    assert not (tmp_path / "bl.json").exists()


def test_update_baseline_refuses_changed_scope(tmp_path):
    proc = _cli("--changed", "--update-baseline", "--baseline",
                str(tmp_path / "bl.json"), timeout=120)
    assert proc.returncode == 2
    assert "requires a full run" in proc.stderr
    assert not (tmp_path / "bl.json").exists()
