"""The port's sklearn family (``SkDt``, ``SkSvm``) against the JAX
package's on the CPU: the same knobs train the same estimators on the
digits, which predict the same probabilities; each package loads the
other's dumped parameters; and a port platform job trains and serves
``SkDt``, its answers the best trial's own predictions.
"""

import _torch_threads  # noqa: F401  (caps torch threads under xdist)
import numpy as np
import pytest

pytest.importorskip("sklearn")

from rafiki_torch.client import Client  # noqa: E402
from rafiki_torch.constants import (BudgetOption, TaskType,  # noqa: E402
                                    UserType)
from rafiki_torch.datasets import prepare_sklearn_digits  # noqa: E402
from rafiki_torch.model.dataset import load_image_dataset  # noqa: E402
from rafiki_torch.models import SkDt, SkSvm  # noqa: E402
from rafiki_tpu.models import sk as rsk  # noqa: E402

ROWS = {"SkDt": (SkDt, rsk.SkDt, {"max_depth": 12, "criterion": "gini",
                                  "min_samples_leaf": 1}),
        "SkSvm": (SkSvm, rsk.SkSvm, {"C": 10.0, "kernel": "rbf",
                                     "max_iter": 1000})}


@pytest.fixture(scope="module")
def digits(tmp_path_factory):
    return prepare_sklearn_digits(str(tmp_path_factory.mktemp("digits")))


@pytest.fixture(scope="module", params=sorted(ROWS))
def trained(request, digits):
    port_cls, ref_cls, knobs = ROWS[request.param]
    pm = port_cls(device="cpu", **port_cls.validate_knobs(knobs))
    rm = ref_cls(**ref_cls.validate_knobs(knobs))
    for m in (pm, rm):
        m.train(digits[0])
    return pm, rm, port_cls, ref_cls, knobs


def _queries(path, n=24):
    ds = load_image_dataset(path)
    return [ds.images[i] for i in range(n)] + [ds.images[0][..., 0]]


def test_the_knob_configs_are_the_reference(trained):
    _, _, port_cls, ref_cls, _ = trained
    p, r = port_cls.get_knob_config(), ref_cls.get_knob_config()
    assert set(p) == set(r)
    for k in p:
        assert p[k].to_json() == r[k].to_json(), k


def test_both_packages_predict_the_same_on_the_digits(trained, digits):
    pm, rm, *_ = trained
    queries = _queries(digits[1])
    got, want = pm.predict(queries), rm.predict(queries)
    assert np.array_equal(np.asarray(got), np.asarray(want))
    assert pm.evaluate(digits[1]) == rm.evaluate(digits[1]) > 0.75
    assert pm.predict([]) == []


def test_each_package_loads_the_other_s_parameters(trained, digits):
    pm, rm, port_cls, ref_cls, knobs = trained
    queries = _queries(digits[1], 8)
    for src, dst_cls in ((pm, ref_cls), (rm, port_cls)):
        params = src.dump_parameters()
        assert params["_sk/estimator"].dtype == np.uint8
        assert params["_meta/n_classes"] == 10
        assert list(params["_meta/image_shape"]) == [8, 8, 1]
        kw = {"device": "cpu"} if dst_cls is port_cls else {}
        dst = dst_cls(**kw, **dst_cls.validate_knobs(knobs))
        dst.load_parameters(params)
        assert np.array_equal(np.asarray(dst.predict(queries)),
                              np.asarray(src.predict(queries)))


def test_a_model_without_parameters_refuses(trained):
    port_cls, knobs = trained[2], trained[4]
    m = port_cls(device="cpu", **port_cls.validate_knobs(knobs))
    with pytest.raises(RuntimeError, match="train"):
        m.predict([np.zeros((8, 8, 1), np.uint8)])
    with pytest.raises(ValueError, match="_sk/estimator"):
        m.load_parameters({})


def test_a_platform_job_trains_and_serves_skdt(tmp_path, digits):
    """Registered by class path, searched by the advisor ``make_advisor``
    picks for its knobs, the best trial deployed behind the predictor:
    each answer is that trial's own ``predict``."""
    from rafiki_torch.platform import LocalPlatform

    p = LocalPlatform(workdir=str(tmp_path / "w"), device="cpu",
                      supervise_interval=0, http=True, n_chips=1)
    try:
        dev = p.admin.create_user("d@x.c", "pw", UserType.MODEL_DEVELOPER)
        model = p.admin.create_model(dev["id"], "dt",
                                     TaskType.IMAGE_CLASSIFICATION,
                                     "rafiki_torch.models.sk:SkDt")
        job = p.admin.create_train_job(
            dev["id"], "dt-app", TaskType.IMAGE_CLASSIFICATION,
            [model["id"]], {BudgetOption.MODEL_TRIAL_COUNT: 3}, *digits)
        assert p.admin.wait_until_train_job_done(job["id"], timeout=300,
                                                 poll=0.2)
        best = p.meta.get_best_trials_of_train_job(job["id"],
                                                   max_count=1)[0]
        assert best["status"] == "COMPLETED" and best["score"] > 0.5
        inf = p.admin.create_inference_job(dev["id"], job["id"],
                                           max_models=1)
        host = p.admin.get_inference_job(inf["id"])["predictor_host"]
        client = Client(admin_port=p.admin_port)
        client.login("d@x.c", "pw")
        queries = _queries(digits[1], 6)
        served = np.asarray(client.predict(host, queries=queries)
                            ["predictions"], np.float64)
        own = SkDt(device="cpu", **best["knobs"])
        own.load_parameters(p.params.load(best["params_id"]))
        np.testing.assert_allclose(
            served, np.asarray(own.predict(queries), np.float64),
            atol=1e-6, rtol=0)
        p.admin.stop_inference_job(inf["id"])
    finally:
        p.shutdown()
