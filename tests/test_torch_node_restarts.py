"""F10: a respawn by the supervise sweep counts
``rafiki_tpu_node_restarts_total{service_type}`` in the port as in the
reference (``rafiki_tpu/admin/services_manager.py`` ``_note_restart``),
the series behind the restarts panel of
``docs/grafana/rafiki_tpu_serving.json``.

Each package counts in its own process-global registry, which other
tests on the same worker may have moved: the checks are on the change
over each test's own respawns.
"""

import _torch_threads  # noqa: F401  (caps torch threads under xdist)

from rafiki_torch.admin.services_manager import \
    ServicesManager as PortServicesManager
from rafiki_torch.constants import (InferenceJobStatus, ServiceStatus,
                                    ServiceType)
from rafiki_torch.observe import metrics as pmetrics
from rafiki_tpu.admin.services_manager import \
    ServicesManager as RefServicesManager
from rafiki_tpu.observe import metrics as rmetrics

NAME = "rafiki_tpu_node_restarts_total"


def _count(metrics, service_type):
    counter = metrics.registry().find(NAME)
    return 0.0 if counter is None else counter.value(
        service_type=service_type)


def test_a_restart_counts_once_in_both_packages():
    dead = {"id": "svc-dead-0001", "service_type": ServiceType.INFERENCE}
    new = {"id": "svc-new-0001"}
    for metrics, note in (
            (pmetrics, lambda *a: PortServicesManager._note_restart(*a)),
            (rmetrics, lambda *a: RefServicesManager._note_restart(
                None, *a))):
        before = _count(metrics, ServiceType.INFERENCE)
        restarted = []
        note(dead, new, restarted)
        note(dead, None, restarted)        # no respawn: nothing counts
        assert restarted == ["svc-new-0001"]
        assert _count(metrics, ServiceType.INFERENCE) - before == 1
    port, ref = (m.registry().find(NAME) for m in (pmetrics, rmetrics))
    assert (port.kind, port.help) == (ref.kind, ref.help)
    assert f'{NAME}{{service_type="INFERENCE"}}' in \
        pmetrics.registry().expose()


def test_the_port_s_supervise_sweep_counts_its_respawn(tmp_path,
                                                       monkeypatch):
    """A dead replica of a RUNNING job, respawned by one sweep of the
    port's platform, counts one restart of its service type."""
    from rafiki_torch.platform import LocalPlatform

    platform = LocalPlatform(workdir=str(tmp_path / "p"),
                             supervise_interval=0, device="cpu")
    try:
        meta = platform.meta
        job = meta.create_inference_job("u-x", "tj-x",
                                        InferenceJobStatus.RUNNING)
        svc = meta.create_service(ServiceType.INFERENCE,
                                  ServiceStatus.RUNNING, chips=[0],
                                  node_id=platform.services.node_id)
        meta.add_inference_job_worker(svc["id"], job["id"], "trial-x")
        monkeypatch.setattr(
            platform.services, "add_inference_worker",
            lambda job_id, trial_id, **kw: {"id": "svc-respawned"})
        before = _count(pmetrics, ServiceType.INFERENCE)
        assert platform.services.supervise() == ["svc-respawned"]
        assert _count(pmetrics, ServiceType.INFERENCE) - before == 1
        assert platform.services.supervise() == []
        assert _count(pmetrics, ServiceType.INFERENCE) - before == 1
    finally:
        platform.shutdown()
