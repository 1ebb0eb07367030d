"""Mutation gates on the port's real source: each gate edits a tmp copy
of ``rafiki_torch/`` (and ``docs/`` where the checker reads it) and the
port's suite must fail with the named code — the acceptance property
that the checkers protect the invariants they claim to. The
counterparts of the reference's gates in ``tests/test_analysis.py``,
plus F7's copy (RTA401), ``PredictRunner``'s clone (RTA402), the
``observe`` package's lazy torch (RTA602) and F10's waiver (RTA301).

The unmutated copy is clean: ``tests/test_torch_analysis.py`` holds
the real tree against the committed baseline, which freezes no finding
of the gates' codes.
"""

import pytest

from _torch_analysis import _assert_bites, _mutated
from rafiki_torch.analysis.core import run_suite


F10_WAIVER = ("            # rta: disable=RTA301 service_type is the bounded "
              "ServiceType vocabulary; supervise counters are deliberately "
              "immortal\n")

# (id, checker, edits, docs, code, anchor or None, text in the message)
GATES = [
    ("serving-stats-remove", "series-lifecycle",
     {"rafiki_torch/observe/serving.py":
      [("m.remove(service=self.service)", "pass")]},
     False, "RTA301", "label:service", None),
    ("trial-series-remove", "series-lifecycle",
     {"rafiki_torch/worker/runner.py":
      [("m.remove(trial=trial_id[:12])", "pass")]},
     False, "RTA301", "label:trial", None),
    ("f10-waiver-removed", "series-lifecycle",
     {"rafiki_torch/admin/services_manager.py": [(F10_WAIVER, "")]},
     False, "RTA301", "label:service_type", None),
    ("waived-finding-fixed-waiver-kept", "series-lifecycle",
     {"rafiki_torch/models/lm.py":
      [("mfu_gauge.set(mfu, **mlabels)", "mfu_gauge.set(mfu)")]},
     False, "RTA003", None, "RTA301"),
    ("f7-staged-copy-aliases", "aliasing",
     {"rafiki_torch/model/torch_model.py":
      [("lambda: (torch.tensor(ds.images, device=device),",
        "lambda: (torch.from_numpy(ds.images).to(device),")]},
     False, "RTA401", "staged_dataset_arrays:from_numpy:ds.images", None),
    ("predict-runner-clone-removed", "aliasing",
     {"rafiki_torch/model/torch_model.py":
      [("return self.static_out.clone()", "return self.static_out")]},
     False, "RTA402", "PredictRunner.__call__:self.static_out", None),
    ("eager-torch-in-observe", "import-hygiene",
     {"rafiki_torch/observe/__init__.py":
      [("import importlib\n", "import importlib\n\nimport torch\n")]},
     False, "RTA602", "eager-torch:torch",
     "rafiki_torch/bus/"),
]


@pytest.mark.parametrize("gate", GATES, ids=[g[0] for g in GATES])
def test_the_gate_bites(gate, tmp_path):
    _id, checker, edits, docs, code, anchor, text = gate
    report = run_suite(_mutated(tmp_path, edits, docs), only=[checker])
    _assert_bites(report, code, anchor, text)
