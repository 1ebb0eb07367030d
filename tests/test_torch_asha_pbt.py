"""The port's ASHA, PBT and prefetching advisors, held against the
reference's on the same seed and the same scripted feedback, and their
path through the port's ``TrialRunner`` and ``LocalPlatform`` (after
``tests/test_asha.py`` and ``tests/test_pbt.py``).

The advisors run on numpy alone, so the two packages' sequences of
proposals (trial numbers, knobs, params types and ``meta``) must be
equal, floats included, exactly.
"""

import _torch_threads  # noqa: F401  (caps torch threads under xdist)
import os

import numpy as np
import pytest

from rafiki_tpu.advisor import AshaAdvisor as RefAsha
from rafiki_tpu.advisor import PbtAdvisor as RefPbt
from rafiki_tpu.advisor import PrefetchAdvisor as RefPrefetch
from rafiki_tpu.advisor.asha import _budget_ladder as ref_ladder
from rafiki_tpu.model import knobs as rknobs
from rafiki_torch.advisor import (AshaAdvisor, PbtAdvisor, PrefetchAdvisor,
                                  make_advisor)
from rafiki_torch.advisor.asha import _budget_ladder
from rafiki_torch.constants import BudgetOption, TrialStatus
from rafiki_torch.model import knobs as pknobs
from rafiki_torch.model.base import BaseModel
from rafiki_torch.store import MetaStore, ParamStore
from rafiki_torch.worker.runner import TrialRunner


def _config(k, top=27):
    return {"width": k.IntegerKnob(8, 64),
            "learning_rate": k.FloatKnob(1e-4, 1e-1, is_exp=True),
            "opt": k.CategoricalKnob(["adam", "sgd", "rms"]),
            "max_epochs": k.IntegerKnob(1, top)}


CONFIG = _config(pknobs)


@pytest.mark.parametrize("make,eta", [
    (lambda k: k.IntegerKnob(1, 27), 3), (lambda k: k.IntegerKnob(2, 20), 3),
    (lambda k: k.IntegerKnob(0, 9), 2), (lambda k: k.IntegerKnob(5, 5), 3),
    (lambda k: k.IntegerKnob(1, 100), 4),
    (lambda k: k.CategoricalKnob([5, 10, 20, 40]), 2),
    (lambda k: k.CategoricalKnob([3, 4, 30]), 3),
    (lambda k: k.CategoricalKnob([30, 1, 9.0, "x", 3]), 3),
    (lambda k: k.CategoricalKnob(["a", "b"]), 3),
    (lambda k: k.FixedKnob(7), 3), (lambda k: None, 3)])
def test_budget_ladders_match_the_reference(make, eta):
    assert _budget_ladder(make(pknobs), eta) == \
        ref_ladder(make(rknobs), eta)


def _trace(p):
    return None if p is None else (p.trial_no, p.knobs, p.params_type,
                                   p.meta)


def _drive(adv, n, batch, forget_every, seed=0):
    """Propose in batches of ``batch`` (several in flight, as parallel
    workers), then answer each with a score from its knobs plus seeded
    noise, forgetting every ``forget_every``-th. Returns the proposals'
    traces and ``best()``."""
    rng = np.random.default_rng(seed)
    out, k = [], 0
    while len(out) < n:
        ps = [adv.propose() for _ in range(batch)]
        out += [_trace(p) for p in ps]
        if all(p is None for p in ps):
            break
        for p in ps:
            if p is None:
                continue
            k += 1
            if forget_every and k % forget_every == 0:
                adv.forget(p)
            else:
                adv.feedback(p, p.knobs["width"] / 64.0
                             + {"adam": 0.1, "sgd": 0.0, "rms": 0.05}[
                                 p.knobs["opt"]] + rng.normal(0, 0.02))
    return out, adv.best()


@pytest.mark.parametrize("seed,eta,batch,forget_every,total", [
    (0, 3, 1, 0, 40), (1, 3, 3, 5, 60), (2, 2, 2, 4, None),
    (3, 4, 4, 0, 30)])
def test_asha_proposes_what_the_reference_proposes(seed, eta, batch,
                                                   forget_every, total):
    got = [_drive(cls(_config(k), seed=seed, eta=eta, total_trials=total),
                  60, batch, forget_every, seed)
           for cls, k in ((AshaAdvisor, pknobs), (RefAsha, rknobs))]
    assert got[0] == got[1]
    proposals = [t for t in got[0][0] if t is not None]
    # Promotions and refunds happened: budgets above rung 0 proposed.
    assert {t[1]["max_epochs"] for t in proposals} > {1}
    assert all(t[3]["ckpt_scope"].startswith("asha-cfg-")
               and t[3]["train_kwargs"] == {"schedule_total_epochs": 27}
               for t in proposals)


@pytest.mark.parametrize("seed,pop,per_round,batch,forget_every,q", [
    (0, 4, None, 1, 0, 0.25), (1, 3, 2, 3, 4, 0.5), (2, 2, 1, 4, 0, 0.5),
    (5, 4, 3, 2, 7, 0.25)])
def test_pbt_proposes_what_the_reference_proposes(seed, pop, per_round,
                                                  batch, forget_every, q):
    """Exploits, perturbations, cumulative budgets clamped at the knob's
    maximum (10 here), and members oversubscribed by batches of
    proposals in flight."""
    got = [_drive(cls(_config(k, top=10), seed=seed, population=pop,
                      epochs_per_round=per_round, quantile=q),
                  48, batch, forget_every, seed)
           for cls, k in ((PbtAdvisor, pknobs), (RefPbt, rknobs))]
    assert got[0] == got[1]
    metas = [t[3] for t in got[0][0]]
    assert any(m["params_scope"] != m["params_save_scope"] for m in metas)
    assert max(m["record_knobs"]["max_epochs"] for m in metas) == 10


def test_pbt_fixed_budget_knob_matches_the_reference():
    got = []
    for cls, k in ((PbtAdvisor, pknobs), (RefPbt, rknobs)):
        adv = cls({"width": k.IntegerKnob(8, 64),
                   "max_epochs": k.FixedKnob(5)}, seed=0, population=2)
        got.append(_drive_simple(adv, 6))
    assert got[0] == got[1]
    assert all(t[1]["max_epochs"] == 5 for t in got[0])


def _drive_simple(adv, n):
    out = []
    for i in range(n):
        p = adv.propose()
        out.append(_trace(p))
        adv.feedback(p, 0.1 * (i % 3))
    return out


def test_make_advisor_builds_asha_and_pbt_with_the_budget():
    for name, cls in (("asha", AshaAdvisor), ("pbt", PbtAdvisor)):
        adv = make_advisor(CONFIG, advisor_type=name, total_trials=3)
        assert isinstance(adv, cls)
        assert [adv.propose() is not None for _ in range(3)] == [True] * 3
        assert adv.propose() is None
    # Never chosen unless asked for.
    assert type(make_advisor(CONFIG)).__name__ == "BayesOptAdvisor"


# --- PrefetchAdvisor ---


def _drive_prefetch(pf, n, forget_at=()):
    """Propose, wait for the prefetch it started (so each proposal is
    computed, deterministically, before the previous one's feedback:
    one observation stale), then answer it."""
    out = []
    for i in range(n):
        p = pf.propose()
        fut = pf._future
        if fut is not None:
            fut.result()
        out.append(_trace(p))
        if p is None:
            continue
        if i in forget_at:
            pf.forget(p)
        else:
            pf.feedback(p, p.knobs["width"] / 64.0)
    return out


def test_prefetch_hands_out_the_references_order_and_refunds_on_close():
    got, inner = [], []
    for asha, pre, k in ((AshaAdvisor, PrefetchAdvisor, pknobs),
                         (RefAsha, RefPrefetch, rknobs)):
        adv = asha(_config(k), seed=4, eta=3, total_trials=20)
        pf = pre(adv)
        got.append(_drive_prefetch(pf, 16, forget_at=(5, 11)))
        pf.close()
        pf.close()  # idempotent
        inner.append((adv._forgotten, sorted(adv._pending)))
        with pytest.raises(RuntimeError, match="closed"):
            pf.propose()
    assert got[0] == got[1]
    # The dangling prefetch (trial 17) was forgotten on close: two
    # refunds from the drive, one from close, nothing pending.
    assert inner[0] == inner[1] == (3, [])


def test_prefetch_asks_again_live_after_a_buffered_none():
    got = []
    for asha, pre, k in ((AshaAdvisor, PrefetchAdvisor, pknobs),
                         (RefAsha, RefPrefetch, rknobs)):
        pf = pre(asha(_config(k), seed=0, total_trials=2))
        p1 = pf.propose()
        p2 = pf.propose()
        pf._future.result()  # the prefetch of a third: None, buffered
        pf.forget(p2)        # an errored trial refunds its slot
        p3 = pf.propose()    # the stale None is asked again, live
        got.append([_trace(p) for p in (p1, p2, p3)]
                   + [_trace(pf.propose())])
        pf.close()
    assert got[0] == got[1]
    assert got[0][2] is not None and got[0][3] is None


def test_prefetch_delegates_and_logs_a_failed_prefetch_on_close(caplog):
    class Flaky:
        def __init__(self):
            self.n = 0
            self.knob_config = CONFIG

        def propose(self):
            self.n += 1
            if self.n == 2:
                raise RuntimeError("advisor down")
            return "p"

        def feedback(self, p, s):
            pass

    pf = PrefetchAdvisor(Flaky())
    assert pf.propose() == "p"
    assert pf.knob_config is CONFIG
    pf.close()
    assert "prefetched proposal failed during close" in caplog.text


# --- Through the TrialRunner ---


def _fake_model(log, config=CONFIG):
    class _Fake(BaseModel):
        @staticmethod
        def get_knob_config():
            return config

        def __init__(self, device=None, **knobs):
            super().__init__(**knobs)
            self._params = {}

        def train(self, path, *, shared_params=None, **kw):
            log.append((self.knobs["max_epochs"], shared_params, dict(kw),
                        self.knobs["width"]))
            self._params = {"w": np.asarray(float(self.knobs["width"]))}

        def evaluate(self, path):
            return self.knobs["width"] / 64.0

        def predict(self, queries):
            return [0 for _ in queries]

        def dump_parameters(self):
            return dict(self._params)

        def load_parameters(self, params):
            self._params = dict(params)

    return _Fake


def test_promotions_share_their_configurations_checkpoint(tmp_path):
    """Every rung of a configuration gets ITS scoped directory, with a
    final save and the ladder-top schedule; the directory survives the
    trial for the next rung, and ``cleanup_scoped_checkpoints`` sweeps
    the sub-job's scopes (only those)."""
    log = []

    class Fake(_fake_model(log)):
        def train(self, path, *, shared_params=None, **kw):
            super().train(path, shared_params=shared_params, **kw)
            os.makedirs(kw["checkpoint_dir"], exist_ok=True)

    params = ParamStore(str(tmp_path / "p"))
    other = os.path.join(params.params_dir, "ckpt", "othersub-asha-cfg-0")
    os.makedirs(other)
    runner = TrialRunner(Fake, AshaAdvisor(CONFIG, seed=3, total_trials=10),
                         "tr", "va", MetaStore(":memory:"), params,
                         sub_train_job_id="asha-warm",
                         budget={BudgetOption.MODEL_TRIAL_COUNT: 10},
                         device="cpu")
    runner.run()
    by_width = {}
    for _, _, kw, w in log:
        by_width.setdefault(w, []).append(kw)
    promoted = {w: kws for w, kws in by_width.items() if len(kws) > 1}
    assert promoted, "no configuration was promoted"
    for kws in promoted.values():
        (d,) = {kw["checkpoint_dir"] for kw in kws}
        assert os.path.basename(d).startswith("asha-warm-asha-cfg-")
        assert os.path.isdir(d)
        assert all(kw["checkpoint_final_epoch"]
                   and kw["schedule_total_epochs"] == 27 for kw in kws)
    runner.cleanup_scoped_checkpoints()
    root = os.path.join(params.params_dir, "ckpt")
    assert os.listdir(root) == ["othersub-asha-cfg-0"]


def test_asha_rows_record_the_cumulative_rung_budgets(tmp_path):
    log = []
    meta = MetaStore(":memory:")
    runner = TrialRunner(_fake_model(log),
                         AshaAdvisor(CONFIG, seed=3, total_trials=8),
                         "tr", "va", meta, ParamStore(str(tmp_path / "p")),
                         sub_train_job_id="asha-rec",
                         budget={BudgetOption.MODEL_TRIAL_COUNT: 8},
                         device="cpu")
    runner.run()
    rows = [t for t in meta.get_trials("asha-rec")
            if t["status"] == TrialStatus.COMPLETED]
    recorded = {t["knobs"]["max_epochs"] for t in rows}
    assert recorded <= {1, 3, 9, 27} and len(recorded) > 1
    assert {e for e, *_ in log} == recorded
    # ASHA warm-starts by checkpoint only: nothing retrieved.
    assert all(shared is None for _, shared, *_ in log)


def test_pbt_weight_lineage_and_cold_start_knobs(tmp_path):
    """A losing member's next round receives the winner's weights and
    saves under its own scope; a round whose retrieval finds nothing
    (here member 1's, from round 2 on) trains its cumulative budget
    (``cold_start_knobs``); every row records the cumulative budget
    (``record_knobs``)."""
    log = []
    meta = MetaStore(":memory:")
    params = ParamStore(str(tmp_path / "p"))
    retrieve = params.retrieve
    scopes = []

    def retrieve_but_member_1(params_type, *, session_id, worker_id=""):
        scopes.append(worker_id)
        if worker_id == "pbt-1":
            return None
        return retrieve(params_type, session_id=session_id,
                        worker_id=worker_id)

    params.retrieve = retrieve_but_member_1
    adv = PbtAdvisor(CONFIG, seed=5, population=2, quantile=0.5,
                     epochs_per_round=2, total_trials=8)
    runner = TrialRunner(_fake_model(log), adv, "tr", "va", meta, params,
                         sub_train_job_id="pbt-e2e",
                         budget={BudgetOption.MODEL_TRIAL_COUNT: 8},
                         device="cpu")
    runner.run()
    rows = sorted(meta.get_trials("pbt-e2e"), key=lambda t: t["no"])
    assert [t["knobs"]["max_epochs"] for t in rows] == [2, 2, 4, 4, 6, 6,
                                                        8, 8]
    executed = [e for e, *_ in log]
    for t, e, (_, shared, _, _) in zip(rows, executed, log):
        assert e == (2 if shared is not None else t["knobs"]["max_epochs"])
    assert executed[0] == executed[1] == 2
    assert any(e > 2 for e in executed)
    # Lineage: a member warm-started from a marker it did not save.
    saved, cross = {}, False
    for i, (_, shared, _, width) in enumerate(log):
        member = i % 2
        if shared is not None and member in saved and \
                float(np.asarray(shared["w"]).reshape(-1)[0]) \
                != saved[member]:
            cross = True
        saved[member] = float(width)
    retrieved_from = {p["meta"]["params_scope"] for p in
                      (t["proposal"] for t in rows)}
    assert retrieved_from <= {"pbt-0", "pbt-1"}
    assert cross or scopes.count("pbt-1") < 4, (log, scopes)
    meta.close()
    params.close()


def test_a_rung_chain_through_the_runner_is_the_uninterrupted_run(
        tmp_path, synth_image_data):
    """A promoted rung's parameters equal, bitwise on the CPU, one
    uninterrupted run of its configuration under the ladder-top
    schedule."""
    from rafiki_torch.models import TorchFeedForward

    class AshaFF(TorchFeedForward):
        @staticmethod
        def get_knob_config():
            cfg = dict(TorchFeedForward.get_knob_config())
            cfg["max_epochs"] = pknobs.IntegerKnob(2, 6)
            cfg["batch_size"] = pknobs.FixedKnob(64)
            return cfg

    train, val = synth_image_data
    meta = MetaStore(":memory:")
    params = ParamStore(str(tmp_path / "p"))
    adv = AshaAdvisor(AshaFF.get_knob_config(), seed=0, eta=3,
                      total_trials=4)
    runner = TrialRunner(AshaFF, adv, train, val, meta, params,
                         sub_train_job_id="asha-ident",
                         budget={BudgetOption.MODEL_TRIAL_COUNT: 4},
                         device="cpu")
    rows = runner.run()
    promoted = [r for r in rows if r["status"] == TrialStatus.COMPLETED
                and r["knobs"]["max_epochs"] == 6]
    assert promoted, "no rung-1 promotion completed"
    promo = promoted[0]
    logs = [x["record"] for x in meta.get_trial_logs(promo["id"])]
    epochs = [x["values"]["epoch"] for x in logs if x["type"] == "values"
              and "epoch" in x["values"]]
    assert epochs == [2, 3, 4, 5]
    model = AshaFF(device="cpu", **AshaFF.validate_knobs(
        dict(promo["knobs"])))
    model.train(train, schedule_total_epochs=6)
    want = model.dump_parameters()
    got = params.load(promo["params_id"])
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), want[k])
    assert promo["score"] == float(model.evaluate(val))


# --- Through LocalPlatform ---

SEARCH_SOURCE = """
from rafiki_torch.model import FixedKnob, IntegerKnob
from rafiki_torch.models import TorchFeedForward


class SearchFF(TorchFeedForward):
    @staticmethod
    def get_knob_config():
        cfg = dict(TorchFeedForward.get_knob_config())
        cfg.update(max_epochs=IntegerKnob(1, 3), batch_size=FixedKnob(64))
        return cfg
"""


@pytest.mark.parametrize("advisor_type", ["asha", "pbt"])
def test_asha_and_pbt_jobs_through_the_platform(tmp_path, synth_image_data,
                                                advisor_type):
    from rafiki_torch.constants import TaskType, UserType
    from rafiki_torch.platform import LocalPlatform

    train, val = synth_image_data
    p = LocalPlatform(workdir=str(tmp_path / "plat"), device="cpu",
                      supervise_interval=0)
    try:
        dev = p.admin.create_user("dev@x.c", "pw", UserType.MODEL_DEVELOPER)
        model = p.admin.create_model(dev["id"], "ff",
                                     TaskType.IMAGE_CLASSIFICATION,
                                     "SearchFF", model_source=SEARCH_SOURCE)
        job = p.admin.create_train_job(
            dev["id"], "app", TaskType.IMAGE_CLASSIFICATION, [model["id"]],
            {BudgetOption.MODEL_TRIAL_COUNT: 5}, train, val,
            advisor_type=advisor_type)
        assert p.admin.wait_until_train_job_done(job["id"], timeout=600)
        detail = p.admin.get_train_job(job["id"])
        assert detail["sub_train_jobs"][0]["n_completed"] == 5
        trials = p.meta.get_trials_of_train_job(job["id"])
        assert all(t["status"] == TrialStatus.COMPLETED for t in trials)
        metas = [t["proposal"]["meta"] for t in trials]
        if advisor_type == "asha":
            assert all(m["ckpt_scope"].startswith("asha-cfg-")
                       for m in metas)
        else:
            assert sorted(t["knobs"]["max_epochs"] for t in trials) == \
                [1, 1, 1, 1, 2]
        # The budget was spent: the worker swept the scoped dirs.
        root = os.path.join(p.params.params_dir, "ckpt")
        assert not os.path.isdir(root) or os.listdir(root) == []
    finally:
        p.shutdown()


def test_stop_train_services_sweeps_scoped_checkpoints(tmp_path):
    from rafiki_torch.admin.services_manager import ServicesManager
    from rafiki_torch.constants import TrainJobStatus, UserType
    from rafiki_torch.container.manager import ThreadContainerManager
    from rafiki_torch.parallel.chips import ChipAllocator

    meta = MetaStore(":memory:")
    user = meta.create_user("a@b.c", "x", UserType.MODEL_DEVELOPER)
    model = meta.create_model(user["id"], "m", "IMAGE_CLASSIFICATION",
                              "mod:Cls", {})
    job = meta.create_train_job(user["id"], "app", "IMAGE_CLASSIFICATION",
                                {}, "tr", "va",
                                status=TrainJobStatus.RUNNING)
    sub = meta.create_sub_train_job(job["id"], model["id"],
                                    status="RUNNING")
    params_dir = str(tmp_path / "params")
    scoped = os.path.join(params_dir, "ckpt", f"{sub['id']}-asha-cfg-0")
    other = os.path.join(params_dir, "ckpt", "othersub-asha-cfg-0")
    os.makedirs(scoped)
    os.makedirs(other)
    sm = ServicesManager(meta, ThreadContainerManager(ctx=None),
                         ChipAllocator(1, device="cpu"), "n1",
                         params_dir=params_dir)
    sm.stop_train_services(job["id"])
    assert not os.path.isdir(scoped)
    assert os.path.isdir(other)
