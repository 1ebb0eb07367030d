"""Mutation gates on the port's real source for the whole-program
concurrency checker (RTA104-RTA106): the counterparts of the
reference's gates in ``tests/test_analysis.py``, each on a tmp copy of
``rafiki_torch/``. Split from ``tests/test_torch_analysis_gates.py``
to keep each file short under the parallel test run."""

import pytest

from _torch_analysis import _assert_bites, _mutated
from rafiki_torch.analysis.core import run_suite


INVERSION = (
    "    def freeze_stats(self):\n"
    "        with self.stats._lock:\n"
    "            with self._cond:\n"
    "                return len(self._queue)\n"
    "\n"
    "    def _retry_after(self) -> float:")

HANDLER = (
    "class _Handler(socketserver.BaseRequestHandler):\n"
    "    def frames_served(self):\n"
    "        return self._frames\n"
    "\n"
    "    def handle(self):\n"
    "        self._frames = getattr(self, \"_frames\", 0) + 1")

# (id, checker, edits, docs, code, anchor or None, text in the message)
GATES = [
    ("persist-stage-unlocked", "concurrency",
     {"rafiki_torch/worker/runner.py": [("with self._lock:", "if True:")]},
     False, "RTA106", "_PersistStage._pending:cross-root", None),
    ("decode-admission-unlocked", "concurrency",
     {"rafiki_torch/worker/decode_scheduler.py":
      [("with self._cv:", "if True:")]},
     False, "RTA106", "DecodeScheduler._pending:cross-root", "'loop'"),
    ("sleep-under-workload-lock", "concurrency",
     {"rafiki_torch/observe/workload.py":
      [("    with _lock:\n"
        "        rec = _state[0] if _state is not None else None\n"
        "        _log_dir = log_dir or None",
        "    with _lock:\n"
        "        time.sleep(0.01)\n"
        "        rec = _state[0] if _state is not None else None\n"
        "        _log_dir = log_dir or None")]},
     False, "RTA105", "configure:time.sleep():direct", None),
    ("broker-handler-root", "concurrency",
     {"rafiki_torch/bus/tcp.py":
      [("class _Handler(socketserver.BaseRequestHandler):\n"
        "    def handle(self):", HANDLER)]},
     False, "RTA106", "_Handler._frames:cross-root", None),
    ("batcher-lock-inversion", "concurrency",
     {"rafiki_torch/predictor/batcher.py":
      [("    def _retry_after(self) -> float:", INVERSION)]},
     False, "RTA104", "MicroBatcher._cond<->ServingStats._lock", None),
]


@pytest.mark.parametrize("gate", GATES, ids=[g[0] for g in GATES])
def test_the_gate_bites(gate, tmp_path):
    _id, checker, edits, docs, code, anchor, text = gate
    report = run_suite(_mutated(tmp_path, edits, docs), only=[checker])
    _assert_bites(report, code, anchor, text)
