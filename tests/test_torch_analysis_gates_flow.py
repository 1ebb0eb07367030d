"""Mutation gates on the port's real source for the distributed seams
and the SLO plane's drift (RTA506, RTA701-RTA703): the counterparts of
the reference's gates in ``tests/test_analysis.py``, each on a tmp copy
of ``rafiki_torch/`` (and ``docs/``). Split from
``tests/test_torch_analysis_gates.py`` to keep each file short under
the parallel test run."""

import pytest

from _torch_analysis import _assert_bites, _mutated
from rafiki_torch.analysis.core import run_suite

GATES = [
    ("renamed-queue-prefix", "flow",
     {"rafiki_torch/cache.py":
      [('push(f"q:{worker_id}"', 'push(f"qx:{worker_id}"')]},
     False, "RTA701", "queue:qx:"),
    ("typod-client-route-call", "flow",
     {"rafiki_torch/client/client.py":
      [('("POST", "/models"', '("POST", "/modelz"')]},
     False, "RTA702", "route-call:POST /modelz"),
    ("fabric-registry-ungated", "flow",
     {"rafiki_torch/platform.py":
      [("        if cluster_fabric_enabled():\n"
        "            from .admin.nodes import NodeRegistry",
        "        if True:\n"
        "            from .admin.nodes import NodeRegistry")]},
     False, "RTA703",
     "RAFIKI_TPU_CLUSTER_FABRIC:unguarded-ctor:NodeRegistry"
     "@LocalPlatform.__init__"),
    ("slo-vocabulary-renamed", "drift",
     {"rafiki_torch/observe/slo.py":
      [('("latency", "job"): "rafiki_tpu_http_request_seconds"',
        '("latency", "job"): "rafiki_tpu_http_request_millis"')]},
     True, "RTA506", "rafiki_tpu_http_request_millis"),
    ("slo-rules-renamed", "drift",
     {"docs/slo/serving.json":
      [("rafiki_tpu_serving_tenant_request_seconds",
        "rafiki_tpu_serving_tenant_latency_seconds")]},
     True, "RTA506", "rafiki_tpu_serving_tenant_latency_seconds"),
]


@pytest.mark.parametrize("gate", GATES, ids=[g[0] for g in GATES])
def test_the_gate_bites(gate, tmp_path):
    _id, checker, edits, docs, code, anchor = gate
    report = run_suite(_mutated(tmp_path, edits, docs), only=[checker])
    _assert_bites(report, code, anchor)
