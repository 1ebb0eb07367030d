"""The port's pipelined persist tail and the train worker's prefetch
(after ``tests/test_trial_pipeline.py``'s persist tests).

With ``pipeline_persist`` the runner hands each completed trial's
persist tail to a single-slot stage: trial N+1's work overlaps trial N's
save, the commits stay in trial order, a tail not yet committed counts
toward the budget (no trial past ``MODEL_TRIAL_COUNT``), ``run`` drains,
a failed tail errs its trial after the fact (its slot refunded, the
breaker tripped by a failure that repeats), and the trial's log records
are flushed by the tail. The ``TrainWorker`` runs that pipeline with a
``PrefetchAdvisor`` unless ``RAFIKI_TPU_ADVISOR_PREFETCH`` is off, and
its ``close`` refunds the last prefetched proposal.
"""

import _torch_threads  # noqa: F401  (caps torch threads under xdist)
import threading
import time

import numpy as np
import pytest

from rafiki_torch.advisor import AshaAdvisor
from rafiki_torch.advisor.base import Proposal
from rafiki_torch.bus import connect
from rafiki_torch.constants import (BudgetOption, ServiceStatus,
                                    ServiceType, TrialStatus, UserType)
from rafiki_torch.model.base import BaseModel
from rafiki_torch.model.knobs import FixedKnob
from rafiki_torch.model.logger import logger
from rafiki_torch.store import MetaStore, ParamStore
from rafiki_torch.worker.runner import TrialRunner

CONFIG = {"width": FixedKnob(32)}


class _FixedAdvisor:
    def __init__(self, knobs):
        self.knobs = knobs
        self.n = 0
        self.feedbacks = []

    def propose(self):
        self.n += 1
        return Proposal(trial_no=self.n, knobs=dict(self.knobs))

    def feedback(self, proposal, score):
        self.feedbacks.append((proposal.trial_no, score))


def _fake_model(events):
    class _Fake(BaseModel):
        @staticmethod
        def get_knob_config():
            return CONFIG

        def __init__(self, device=None, **knobs):
            super().__init__(**knobs)

        def train(self, path, *, shared_params=None, **kw):
            events.append(("train", time.monotonic()))
            logger.log(msg="fake trained")
            self._params = {"w": np.asarray(1.0)}

        def evaluate(self, path):
            return 0.5

        def predict(self, queries):
            return [0 for _ in queries]

        def dump_parameters(self):
            return dict(self._params)

        def load_parameters(self, params):
            self._params = dict(params)

    return _Fake


def _stores(tmp_path):
    return MetaStore(":memory:"), ParamStore(str(tmp_path / "p"))


def test_the_tail_overlaps_orders_and_drains(tmp_path, monkeypatch):
    meta, params = _stores(tmp_path)
    events = []
    orig_save = params.save

    def slow_save(ps, **kw):
        events.append(("save_start", time.monotonic()))
        time.sleep(0.15)
        out = orig_save(ps, **kw)
        events.append(("save_end", time.monotonic()))
        return out

    monkeypatch.setattr(params, "save", slow_save)
    advisor = _FixedAdvisor({"width": 32})
    runner = TrialRunner(_fake_model(events), advisor, "tr", "va", meta,
                         params, "sub-pipe",
                         budget={BudgetOption.MODEL_TRIAL_COUNT: 3},
                         device="cpu", pipeline_persist=True)
    rows = runner.run()
    runner.close()
    # run() returns the rows after the drain: terminal, with params.
    assert [r["status"] for r in rows] == [TrialStatus.COMPLETED] * 3
    assert all(r["params_id"] for r in rows)
    trials = sorted(meta.get_trials("sub-pipe"), key=lambda t: t["no"])
    assert [t["status"] for t in trials] == [TrialStatus.COMPLETED] * 3
    # The budget stays exact with completions the meta store could not
    # see yet: three proposals, not four.
    assert advisor.n == 3
    finished = [t["finished_at"] for t in trials]
    assert finished == sorted(finished)
    saves = [(t0, next(t1 for n1, t1 in events
                       if n1 == "save_end" and t1 > t0))
             for n0, t0 in events if n0 == "save_start"]
    trains = [t for n, t in events if n == "train"]
    assert any(s0 < t < s1 for t in trains for s0, s1 in saves), events
    logs = meta.get_trial_logs(trials[0]["id"])
    assert any(r["record"].get("values", {}).get("msg") == "fake trained"
               for r in logs)
    meta.close()
    params.close()


def test_a_pending_tail_counts_against_the_budget(tmp_path, monkeypatch):
    """The budget check while a tail is in flight: the pending
    completion counts, so a budget of 1 proposes once."""
    meta, params = _stores(tmp_path)
    gate = threading.Event()
    orig_save = params.save
    checks = []

    def held_save(ps, **kw):
        gate.wait(5)
        return orig_save(ps, **kw)

    monkeypatch.setattr(params, "save", held_save)
    advisor = _FixedAdvisor({"width": 32})
    runner = TrialRunner(_fake_model([]), advisor, "tr", "va", meta, params,
                         "sub-budget",
                         budget={BudgetOption.MODEL_TRIAL_COUNT: 1},
                         device="cpu", pipeline_persist=True)
    row = runner.run_one()
    assert row["status"] == TrialStatus.RUNNING
    checks.append(runner._should_stop())
    assert meta.get_trials("sub-budget",
                           status=TrialStatus.COMPLETED) == []
    gate.set()
    runner.drain_persist()
    checks.append(runner._should_stop())
    runner.close()
    assert checks == [True, True] and advisor.n == 1
    assert meta.get_trial(row["id"])["status"] == TrialStatus.COMPLETED
    meta.close()
    params.close()


def test_a_failed_tail_errs_its_trial(tmp_path, monkeypatch):
    meta, params = _stores(tmp_path)

    def bad_save(ps, **kw):
        raise RuntimeError("disk full (injected)")

    monkeypatch.setattr(params, "save", bad_save)
    advisor = _FixedAdvisor({"width": 32})
    runner = TrialRunner(_fake_model([]), advisor, "tr", "va", meta, params,
                         "sub-err", budget={BudgetOption.MODEL_TRIAL_COUNT: 1},
                         device="cpu", pipeline_persist=True)
    assert runner.run_one() is not None
    runner.drain_persist()
    runner.close()
    trial = meta.get_trials("sub-err")[0]
    assert trial["status"] == TrialStatus.ERRORED
    assert "disk full" in trial["error"]
    # The score was real: the advisor heard it anyway.
    assert advisor.feedbacks == [(1, 0.5)]
    meta.close()
    params.close()


def test_a_stop_drains_and_leaves_no_running_row(tmp_path, monkeypatch):
    meta, params = _stores(tmp_path)
    orig_save = params.save
    monkeypatch.setattr(
        params, "save",
        lambda ps, **kw: (time.sleep(0.2), orig_save(ps, **kw))[1])
    stop = threading.Event()

    class _StopAfterOne(_FixedAdvisor):
        def feedback(self, proposal, score):
            super().feedback(proposal, score)
            stop.set()

    runner = TrialRunner(_fake_model([]), _StopAfterOne({"width": 32}),
                         "tr", "va", meta, params, "sub-stop",
                         budget={BudgetOption.MODEL_TRIAL_COUNT: 50},
                         device="cpu", stop_flag=stop,
                         pipeline_persist=True)
    runner.run()
    runner.close()
    trials = meta.get_trials("sub-stop")
    assert trials and all(t["status"] != TrialStatus.RUNNING
                          for t in trials)
    meta.close()
    params.close()


def test_repeated_tail_failures_trip_the_breaker(tmp_path, monkeypatch):
    meta, params = _stores(tmp_path)
    monkeypatch.setattr(
        params, "save",
        lambda ps, **kw: (_ for _ in ()).throw(
            RuntimeError("disk full (injected)")))
    runner = TrialRunner(_fake_model([]), _FixedAdvisor({"width": 32}),
                         "tr", "va", meta, params, "sub-breaker",
                         budget={BudgetOption.MODEL_TRIAL_COUNT: 50},
                         device="cpu", pipeline_persist=True)
    runner.run()
    runner.close()
    trials = meta.get_trials("sub-breaker")
    assert 3 <= len(trials) <= 5
    assert all(t["status"] == TrialStatus.ERRORED for t in trials)
    meta.close()
    params.close()


def test_a_failed_last_tail_refunds_its_slot(tmp_path, monkeypatch):
    meta, params = _stores(tmp_path)
    orig_save = params.save
    calls = [0]

    def flaky_save(ps, **kw):
        calls[0] += 1
        if calls[0] == 1:
            raise RuntimeError("transient disk error (injected)")
        return orig_save(ps, **kw)

    monkeypatch.setattr(params, "save", flaky_save)
    runner = TrialRunner(_fake_model([]), _FixedAdvisor({"width": 32}),
                         "tr", "va", meta, params, "sub-refund",
                         budget={BudgetOption.MODEL_TRIAL_COUNT: 2},
                         device="cpu", pipeline_persist=True)
    runner.run()
    runner.close()
    by_status = {}
    for t in meta.get_trials("sub-refund"):
        by_status[t["status"]] = by_status.get(t["status"], 0) + 1
    assert by_status == {TrialStatus.COMPLETED: 2, TrialStatus.ERRORED: 1}
    meta.close()
    params.close()


def test_without_the_pipeline_the_tail_runs_inline(tmp_path):
    meta, params = _stores(tmp_path)
    runner = TrialRunner(_fake_model([]), _FixedAdvisor({"width": 32}),
                         "tr", "va", meta, params, "sub-inline",
                         budget={BudgetOption.MODEL_TRIAL_COUNT: 1},
                         device="cpu")
    row = runner.run_one()
    assert row["status"] == TrialStatus.COMPLETED and row["params_id"]
    runner.close()
    meta.close()
    params.close()


# --- The TrainWorker ---

WORKER_SOURCE = """
import numpy as np
from rafiki_torch.model import IntegerKnob
from rafiki_torch.model.base import BaseModel


class Fake(BaseModel):
    @staticmethod
    def get_knob_config():
        return {"width": IntegerKnob(8, 64), "max_epochs": IntegerKnob(1, 9)}

    def __init__(self, device=None, **knobs):
        super().__init__(**knobs)

    def train(self, path, *, shared_params=None, **kw):
        self._p = {"w": np.asarray(float(self.knobs["width"]))}

    def evaluate(self, path):
        return self.knobs["width"] / 64.0

    def predict(self, queries):
        return [0 for _ in queries]

    def dump_parameters(self):
        return dict(self._p)

    def load_parameters(self, params):
        self._p = dict(params)
"""


def _worker(tmp_path, monkeypatch, prefetch, n_trials=4):
    from rafiki_torch.model.knobs import IntegerKnob
    from rafiki_torch.worker.train import TrainWorker

    if prefetch is not None:
        monkeypatch.setenv("RAFIKI_TPU_ADVISOR_PREFETCH", prefetch)
    else:
        monkeypatch.delenv("RAFIKI_TPU_ADVISOR_PREFETCH", raising=False)
    meta, params = _stores(tmp_path)
    user = meta.create_user("a@b.c", "x", UserType.MODEL_DEVELOPER)
    model = meta.create_model(user["id"], "fake", "IMAGE_CLASSIFICATION",
                              "Fake", {}, model_source=WORKER_SOURCE)
    job = meta.create_train_job(user["id"], "app", "IMAGE_CLASSIFICATION",
                                {BudgetOption.MODEL_TRIAL_COUNT: n_trials},
                                "tr", "va", status="RUNNING")
    sub = meta.create_sub_train_job(job["id"], model["id"],
                                    status="RUNNING")
    svc = meta.create_service(ServiceType.TRAIN, ServiceStatus.STARTED)
    adv = AshaAdvisor({"width": IntegerKnob(8, 64),
                       "max_epochs": IntegerKnob(1, 9)}, seed=0,
                       total_trials=n_trials)
    scoped = f"{params.params_dir}/ckpt/{sub['id']}-asha-cfg-99"
    import os
    os.makedirs(scoped)
    w = TrainWorker(svc["id"], sub["id"], meta, params, connect(""),
                    advisor=adv, device="cpu")
    return w, adv, meta, params, sub, scoped


@pytest.mark.parametrize("prefetch", [None, "0"])
def test_the_train_worker_prefetches_and_refunds_on_close(
        tmp_path, monkeypatch, prefetch):
    """By default the worker's advisor is prefetched: the proposal after
    the budget's last is computed and, at close, forgotten (a refund
    the advisor counts); with the switch off nothing is prefetched.
    Either way the budget's trials complete, the service row ends
    STOPPED and the spent budget sweeps the sub-job's scoped
    checkpoints."""
    import os

    from rafiki_torch.advisor import prefetch as prefetch_mod

    built = []
    real = prefetch_mod.PrefetchAdvisor

    class Counting(real):
        def __init__(self, advisor):
            built.append(self)
            super().__init__(advisor)

    monkeypatch.setattr("rafiki_torch.worker.train.PrefetchAdvisor",
                        Counting)
    w, adv, meta, params, sub, scoped = _worker(tmp_path, monkeypatch,
                                                prefetch)
    w.start()
    w.join(60)
    assert not w.running
    trials = meta.get_trials(sub["id"])
    assert len(trials) == 4
    assert all(t["status"] == TrialStatus.COMPLETED for t in trials)
    assert meta.get_service(w.service_id)["status"] == ServiceStatus.STOPPED
    assert not os.path.exists(scoped)
    if prefetch is None:
        assert len(built) == 1 and built[0]._closed
        # 4 trials handed out; the 5th was prefetched (None: the budget
        # is spent) or computed and refunded at close.
        assert adv._trial_no - adv._forgotten == 4
        assert adv._pending == {}
    else:
        assert built == [] and adv._trial_no == 4 and adv._forgotten == 0
    meta.close()
    params.close()


def test_a_stopped_worker_keeps_the_scoped_checkpoints(tmp_path,
                                                       monkeypatch):
    """A stop is not the budget spent: the scoped directories stay for
    the ServicesManager's sweep (or a restarted worker's next rung)."""
    import os

    w, adv, meta, params, sub, scoped = _worker(tmp_path, monkeypatch,
                                                None, n_trials=50)
    w.stop_flag.set()
    w.start()
    w.join(60)
    assert os.path.isdir(scoped)
    assert meta.get_service(w.service_id)["status"] == ServiceStatus.STOPPED
    meta.close()
    params.close()
