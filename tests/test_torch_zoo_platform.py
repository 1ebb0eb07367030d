"""An ENAS search through the port's platform on the CPU.

A ``TorchEnas`` subclass at test sizes (2 blocks, 3 cells of 8 channels,
batch 16, one epoch), uploaded as ``model_source``, runs as a train job
created through ``Client`` with no ``advisor_type``. The advisor service
must build ``EnasAdvisor`` (the reference's automatic choice for an
``ArchKnob`` space), its controller on the platform's device; the search
trials train the masked supernet on ``GLOBAL_RECENT`` warm starts from
the platform's ``ParamStore``, each after the first overlaying every
supernet tensor; the final trial retrains the best search trial's
architecture from scratch on the single-path network.
"""

import _torch_threads  # noqa: F401  (caps torch threads under xdist)
from rafiki_torch.client import Client
from rafiki_torch.constants import (BudgetOption, ServiceType, TaskType,
                                    TrialStatus, UserType)
from rafiki_torch.datasets import make_synthetic_image_dataset

TINY_ENAS = '''
from rafiki_torch.model import FixedKnob
from rafiki_torch.models import TorchEnas


class TinyEnas(TorchEnas):
    n_blocks = 2
    full_cells, full_channels = 3, 8
    search_cells, search_channels = 3, 8

    @classmethod
    def get_knob_config(cls):
        cfg = super().get_knob_config()
        cfg.update(batch_size=FixedKnob(16), max_epochs=FixedKnob(1))
        return cfg
'''
TRIALS = 5  # 4 search trials and 1 final (final_train_frac 0.15)


def _warm_starts(dev, trial_id):
    msgs = [r["record"]["values"].get("msg", "")
            for r in dev.get_trial_logs(trial_id)
            if r["record"]["type"] == "values"]
    return [int(m.split()[1]) for m in msgs
            if str(m).startswith("warm-started")]


def test_an_enas_job_without_an_advisor_type_runs_the_enas_advisor(
        tmp_path):
    from rafiki_torch.platform import LocalPlatform

    train, val = make_synthetic_image_dataset(
        str(tmp_path / "data"), n_train=64, n_val=32,
        image_shape=(32, 32, 3), n_classes=10, seed=0)
    p = LocalPlatform(workdir=str(tmp_path / "port"), device="cpu",
                      supervise_interval=0, http=True, n_chips=1)
    try:
        root = Client(admin_port=p.admin_port)
        root.login("superadmin@rafiki", "rafiki")
        root.create_user("enas@x.c", "pw", UserType.MODEL_DEVELOPER)
        dev = Client(admin_port=p.admin_port)
        dev.login("enas@x.c", "pw")
        model = dev.create_model("tiny-enas", TaskType.IMAGE_CLASSIFICATION,
                                 "TinyEnas", model_source=TINY_ENAS)
        job = dev.create_train_job(
            "enas", TaskType.IMAGE_CLASSIFICATION, [model["id"]],
            {BudgetOption.MODEL_TRIAL_COUNT: TRIALS}, train, val)
        (svc,) = [s for s in dev.get_services()
                  if s["service_type"] == ServiceType.ADVISOR]
        advisor = p.container.get(svc["id"]).advisor
        assert type(advisor).__name__ == "EnasAdvisor"
        assert advisor.device.type == "cpu"
        done = dev.wait_until_train_job_done(job["id"], timeout=600,
                                             poll=0.2)
        assert done["status"] == "STOPPED"
        trials = sorted(dev.get_trials_of_train_job(job["id"]),
                        key=lambda t: t["no"])
        assert len(trials) == TRIALS
        assert all(t["status"] == TrialStatus.COMPLETED for t in trials)
        search, final = trials[:-1], trials[-1]
        assert all(t["knobs"]["share_params"] and t["knobs"]["downscale"]
                   for t in search)
        assert not final["knobs"]["share_params"]
        # The train worker prefetches each proposal while the trial
        # before it trains, one observation stale: the final proposal
        # was made before the last search trial's score came, so it
        # retrains the best of the search trials scored by then.
        best = max(search[:-1], key=lambda t: t["score"])
        assert final["knobs"]["arch"] == best["knobs"]["arch"]
        # Warm starts through the platform's ParamStore: none for the
        # first search trial and the final one, every supernet tensor
        # (stored, without the two _meta entries) for the others.
        # The worker's persist tail is pipelined: trial N's save may
        # still be in flight when trial N+1 retrieves, but trial N-1's
        # has landed (one tail in flight at a time), so the second
        # search trial may start cold and every later one warm.
        n_supernet = len(p.params.load(search[0]["params_id"])) - 2
        assert _warm_starts(dev, search[0]["id"]) == []
        assert _warm_starts(dev, search[1]["id"]) in ([], [n_supernet])
        for t in search[2:]:
            assert _warm_starts(dev, t["id"]) == [n_supernet], t["no"]
        assert _warm_starts(dev, final["id"]) == []
        n_single = len(p.params.load(final["params_id"])) - 2
        assert n_single < n_supernet
    finally:
        p.shutdown()
