"""BASELINE config 5 on the CPU: two tenants' train jobs on one chip of
the port's ``LocalPlatform``, as ``tests/test_multitenant.py`` runs them
on the reference.

Two users each submit a ``TorchFeedForward`` job of 2 trials with
``CHIP_COUNT`` 1 to a platform of one chip: the second is admitted
time-sliced on the chip the first holds, both finish every trial, and
their windows (first trial's start to last trial's end) overlap. The
admin's ``/trial_phases`` then counts one propose, train, eval and
persist a trial, and ``/trial_phases`` and ``/status`` have the
reference's keys (the reference's platform built beside, its bodies read
in process). ``/status`` reads ``mfu`` from the train loops' gauge by
trial, as the reference's does (the CPU publishes no utilization, so
the test sets the gauge itself). Counts are exact.
"""

import _torch_threads  # noqa: F401  (caps torch threads under xdist)
import json
import urllib.request

import pytest

from rafiki_torch.client import Client
from rafiki_torch.constants import (BudgetOption, TaskType, TrialStatus,
                                    UserType)
from rafiki_torch.observe import metrics, phases

PORT_FF = "rafiki_torch.models.feedforward:TorchFeedForward"
TRIALS = 2
PHASES = ("propose", "load", "stage", "train", "eval", "persist")


def _get(port, token, path):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        headers={"Authorization": f"Bearer {token}"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.status, json.loads(r.read())


@pytest.fixture()
def one_chip(tmp_path):
    from rafiki_torch.platform import LocalPlatform

    p = LocalPlatform(workdir=str(tmp_path / "port"), n_chips=1,
                      device="cpu", http=True, supervise_interval=0)
    try:
        yield p
    finally:
        p.shutdown()


def test_two_tenants_share_one_chip(one_chip, synth_image_data):
    p = one_chip
    train_path, val_path = synth_image_data
    root = Client(admin_port=p.admin_port)
    root.login("superadmin@rafiki", "rafiki")
    before = phases.phase_totals()
    jobs, tenants = [], []
    for i in range(2):
        root.create_user(f"t{i}@x.c", "pw", UserType.MODEL_DEVELOPER)
        c = Client(admin_port=p.admin_port)
        c.login(f"t{i}@x.c", "pw")
        model = c.create_model(f"ff{i}", TaskType.IMAGE_CLASSIFICATION,
                               PORT_FF)
        jobs.append(c.create_train_job(
            f"app{i}", TaskType.IMAGE_CLASSIFICATION, [model["id"]],
            {BudgetOption.MODEL_TRIAL_COUNT: TRIALS,
             BudgetOption.CHIP_COUNT: 1}, train_path, val_path,
            advisor_type="random"))
        tenants.append(c)
    # The second job found no free chip and co-owns the first's.
    assert p.allocator.free_chips == 0
    assert any(len(o) >= 2 for o in p.allocator._owners)
    for c, j in zip(tenants, jobs):
        c.wait_until_train_job_done(j["id"], timeout=300, poll=0.1)
    windows = []
    for j in jobs:
        trials = p.meta.get_trials_of_train_job(j["id"])
        assert [t["status"] for t in trials] == \
            [TrialStatus.COMPLETED] * TRIALS
        windows.append((min(t["started_at"] for t in trials),
                        max(t["finished_at"] for t in trials)))
    (a0, a1), (b0, b1) = windows
    assert a0 < b1 and b0 < a1, f"jobs ran one after the other: {windows}"

    status, body = _get(p.admin_port, root._token, "/trial_phases")
    assert status == 200
    counts = {k: body["phases"][k]["count"] - before[k]["count"]
              for k in PHASES}
    n = 2 * TRIALS
    assert counts == {"propose": n, "load": 2 * n, "stage": 2 * n,
                      "train": n, "eval": n, "persist": n}
    status, st = _get(p.admin_port, root._token, "/status")
    assert status == 200 and st["mfu"] == {}  # no trial runs now
    assert p.allocator.free_chips == 1


def test_status_and_trial_phases_have_the_references_keys(one_chip,
                                                          tmp_path):
    from rafiki_tpu.observe import metrics as ref_metrics
    from rafiki_tpu.platform import LocalPlatform as RefPlatform

    ref = RefPlatform(workdir=str(tmp_path / "ref"), supervise_interval=0)
    try:
        root = Client(admin_port=one_chip.admin_port)
        root.login("superadmin@rafiki", "rafiki")
        gauges = [(ref_metrics, ref.admin.get_status),
                  (metrics, lambda: _get(one_chip.admin_port, root._token,
                                         "/status")[1])]
        seen = []
        for reg, status in gauges:
            g = reg.registry().gauge("rafiki_tpu_train_mfu_ratio")
            g.set(0.123456, trial="abcdef012345")
            try:
                seen.append(status())
            finally:
                g.remove(trial="abcdef012345")
        ref_status, port_status = seen
        assert set(port_status) == set(ref_status) - {"cluster"}
        # Other tests in this process may have left series in the
        # reference's registry: read the one set here.
        assert port_status["mfu"]["abcdef012345"] == \
            ref_status["mfu"]["abcdef012345"] == 0.1235
        port_phases = _get(one_chip.admin_port, root._token,
                           "/trial_phases")[1]
        ref_phases = ref.admin.get_trial_phases()
        assert set(port_phases) == set(ref_phases)
        assert set(port_phases["caches"]) == set(ref_phases["caches"])
        assert set(port_phases["phases"]) == set(ref_phases["phases"])
        for p in PHASES:
            assert set(port_phases["phases"][p]) == \
                set(ref_phases["phases"][p]) == {"count", "total_s",
                                                 "mean_ms"}
    finally:
        ref.shutdown()
