"""A train job whose budget sets ``CHIPS_PER_TRIAL`` 4, through the admin
on a CPU platform of 4 chips, against the reference's platform on 4 of
its 8 virtual devices.

Each package's services manager gives the job's one train worker a
group of the 4 chips, the worker binds it to its thread, and its trial
of ``TorchFeedForward`` (``JaxFeedForward``) trains over the group's
mesh, dp 4: the port's train steps go through ``parallel.data`` once a
rank (counted here). The trial is persisted, deployed and answered by
``POST /predict``; the port's answer is held against its trial's own
parameters loaded on a single device (1e-6: one member's probabilities
through the float64 mean) and against the reference's model on the same
parameter file (3.9e-3, ``test_torch_platform.py``'s ``TOL_JAX``). Both
packages end with the same trial statuses and every chip free.
"""

import _torch_threads  # noqa: F401  (caps torch threads under xdist)

import numpy as np

from rafiki_torch.client import Client
from rafiki_torch.constants import (BudgetOption, ServiceType, TaskType,
                                    TrialStatus, UserType)
from rafiki_torch.model import torch_model
from test_torch_platform import PORT_FF, REF_FF, TOL_JAX, TOL_MEAN, _port, _ref


def test_a_chips_per_trial_job_trains_on_its_group_and_serves(
        tmp_path, synth_image_data, monkeypatch):
    from rafiki_torch.model.dataset import load_image_dataset
    from rafiki_torch.models import TorchFeedForward
    from rafiki_tpu.models.feedforward import JaxFeedForward
    from rafiki_tpu.store import ParamStore as RefParamStore

    ranks = []
    real = torch_model.mesh_apply

    def mesh_apply(mesh, *args, **kwargs):
        ranks.append(mesh.shape["dp"])
        return real(mesh, *args, **kwargs)

    monkeypatch.setattr(torch_model, "mesh_apply", mesh_apply)
    train_path, val_path = synth_image_data
    queries = [load_image_dataset(val_path).images[i] for i in range(6)]
    seen = {}
    for kind, make, ff in (("port", _port, PORT_FF), ("ref", _ref, REF_FF)):
        p = make(tmp_path / kind, http=True, n_chips=4)
        try:
            dev = p.admin.create_user("d@x.c", "pw",
                                      UserType.MODEL_DEVELOPER)
            model = p.admin.create_model(dev["id"], "ff",
                                         TaskType.IMAGE_CLASSIFICATION, ff)
            job = p.admin.create_train_job(
                dev["id"], "dp-app", TaskType.IMAGE_CLASSIFICATION,
                [model["id"]], {BudgetOption.MODEL_TRIAL_COUNT: 1,
                                "CHIPS_PER_TRIAL": 4},
                train_path, val_path, advisor_type="random")
            assert p.admin.wait_until_train_job_done(job["id"], timeout=600,
                                                     poll=0.2)
            trains = [s for s in p.meta.get_services()
                      if s["service_type"] == ServiceType.TRAIN]
            trials = p.meta.get_trials_of_train_job(job["id"])
            inf = p.admin.create_inference_job(dev["id"], job["id"],
                                               max_models=1)
            host = p.admin.get_inference_job(inf["id"])["predictor_host"]
            client = Client(admin_port=p.admin_port)
            client.login("d@x.c", "pw")
            probs = np.asarray(client.predict(host, queries=queries)
                               ["predictions"], np.float64)
            assert probs.shape == (6, 4)
            if kind == "port":
                (row,) = trials
                m = TorchFeedForward(device="cpu", **row["knobs"])
                m.load_parameters(p.params.load(row["params_id"]))
                assert m.mesh.size == 1
                own = np.asarray(m.predict(queries), np.float64)
                assert np.abs(probs - own).max() <= TOL_MEAN
                ref_params = RefParamStore(p.params.params_dir)
                jm = JaxFeedForward(
                    **JaxFeedForward.validate_knobs(row["knobs"]))
                jm.load_parameters(ref_params.load(row["params_id"]))
                assert np.abs(probs - np.asarray(jm.predict(queries))
                              ).max() <= TOL_JAX
                ref_params.close()
            seen[kind] = ([len(s["chips"]) for s in trains],
                          sorted(t["status"] for t in trials))
            p.admin.stop_inference_job(inf["id"])
            assert p.allocator.free_chips == p.allocator.n_chips
        finally:
            p.shutdown()
    assert seen["port"] == seen["ref"] == ([4], [TrialStatus.COMPLETED])
    # Every train step of the trial ran over the group's 4 dp ranks.
    assert ranks and set(ranks) == {4}
