"""Trial promotion into a running inference job, on the port's
``LocalPlatform(device="cpu")`` beside the reference's.

The flow of the reference's ``tests/test_promotion.py``, on both
platforms with the same calls: four COMPLETED ``TorchFeedForward``
(``JaxFeedForward`` on the reference) trials of one train job are
written into each platform's stores with the same seeded parameters;
the 2 best are deployed on one chip, so one worker serves them as a
stacked 2-member bin. Then

- a surgical promote (``POST /inference_jobs/<id>/promote`` with
  ``replace_trial_id``) restacks the weaker member in place: no new
  service, the registration shows the new bin;
- an additive promote adds a bin served by a second worker;
- after each, a query the edge cache held misses (no stale answer).

The port's answers are held against the float64 mean of the served
members' own ``predict`` within 1e-6, and against the reference's
answers to the same queries within 3.9e-3 (one bf16 ulp of a logit
below 4, ``tests/test_torch_feedforward.py``). Both platforms must give
the same response keys and the same validation errors (ids masked).

A second test holds the ViT restack at 2 blocks: a stacked bin after
``replace_member`` gives the rows of a bin built fresh from the new
members within 1e-6, and the reference's stacked ViT on the same
parameters (run as ``tests/test_stacked.py`` runs it) within the f32
tolerance of ``tests/test_torch_stacked.py``.
"""

import _torch_threads  # noqa: F401  (caps torch threads under xdist)
import json
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from rafiki_torch.cache import Cache, encode_payload
from rafiki_torch.constants import ServiceType, TaskType, UserType
from rafiki_torch.models import TorchFeedForward

SHAPE = (12, 12, 1)
N_CLASSES = 4
TOL_MEAN = 1e-6
TOL_JAX = 3.9e-3
KNOBS = [dict(hidden_layer_count=c, hidden_layer_units=u,
              learning_rate=1e-3, batch_size=32)
         for c, u in ((2, 64), (3, 128), (1, 96), (2, 32), (3, 48))]
SCORES = (0.9, 0.8, 0.7, 0.6, 0.5)


def _params(seed):
    """Feed-forward supernet parameters in the reference's flat names."""
    rng = np.random.default_rng(seed)
    widths = [int(np.prod(SHAPE)), 128, 128, 128, N_CLASSES]
    p = {}
    for i in range(4):
        p[f"params/Dense_{i}/kernel"] = (
            rng.standard_normal((widths[i], widths[i + 1]))
            / np.sqrt(widths[i])).astype(np.float32)
        p[f"params/Dense_{i}/bias"] = (
            0.1 * rng.standard_normal(widths[i + 1])).astype(np.float32)
    p["_meta/n_classes"] = np.asarray(N_CLASSES)
    p["_meta/image_shape"] = np.asarray(SHAPE)
    return p


def _platform(kind, path):
    if kind == "port":
        from rafiki_torch.platform import LocalPlatform

        return LocalPlatform(workdir=str(path), device="cpu", n_chips=1,
                             http=True, supervise_interval=0)
    from rafiki_tpu.platform import LocalPlatform

    return LocalPlatform(workdir=str(path), n_chips=1, http=True,
                         supervise_interval=0)


def _seed_job(platform, ff_class, name, n_trials, statuses=None):
    """A train job of ``n_trials`` trials written into the stores: trial
    i has ``KNOBS[i]``, ``_params(i)`` and score ``SCORES[i]``."""
    dev = platform.meta.get_user_by_email("dev@x.c") or \
        platform.admin.create_user("dev@x.c", "pw",
                                   UserType.MODEL_DEVELOPER)
    model = platform.admin.create_model(
        dev["id"], name, TaskType.IMAGE_CLASSIFICATION, ff_class)
    job = platform.meta.create_train_job(
        dev["id"], name, TaskType.IMAGE_CLASSIFICATION, {}, "-", "-",
        "STOPPED")
    sub = platform.meta.create_sub_train_job(job["id"], model["id"],
                                             "STOPPED")
    ids = []
    for i in range(n_trials):
        t = platform.meta.create_trial(sub["id"], model["id"], i + 1,
                                       "RUNNING", knobs=KNOBS[i])
        if (statuses or {}).get(i) != "RUNNING":
            platform.meta.mark_trial_completed(
                t["id"], SCORES[i],
                platform.params.save(_params(i), session_id="promote"))
        ids.append(t["id"])
    return dev, job, ids


def _call(port, method, path, token, body=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", method=method,
        data=json.dumps(body).encode() if body is not None else None,
        headers={"Authorization": f"Bearer {token}",
                 "Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _login(port):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/tokens", method="POST",
        data=json.dumps({"email": "superadmin@rafiki",
                         "password": "rafiki"}).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=30) as r:
        return json.loads(r.read())["token"]


def _predict(host, queries):
    req = urllib.request.Request(
        f"http://{host}/predict", method="POST",
        data=json.dumps({"queries": [encode_payload(q)
                                     for q in queries]}).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return np.asarray(json.loads(r.read())["predictions"])


def _bins(platform, inf_id, cache_cls, names):
    """The registered bins, ids masked by ``names``, sorted."""
    info = cache_cls(platform.bus).running_worker_info(inf_id)
    return sorted(_masked(str(i["trial_id"]), names)
                  for i in info.values())


def _wait_registered(platform, inf_id, cache_cls, n):
    deadline = time.monotonic() + 60
    while len(cache_cls(platform.bus).running_workers(inf_id)) < n:
        assert time.monotonic() < deadline, "workers did not register"
        time.sleep(0.05)


def _events(platform):
    pred = next(s for s in platform.meta.get_services()
                if s["service_type"] == ServiceType.PREDICT)
    return platform.container.get(pred["id"]).edge_cache.info()["events"]


def _own_mean(trial_idx, imgs):
    rows = []
    for i in trial_idx:
        m = TorchFeedForward(device="cpu",
                             **TorchFeedForward.validate_knobs(KNOBS[i]))
        m.load_parameters(_params(i))
        rows.append(np.asarray(m.predict(list(imgs)), np.float64))
        m.destroy()
    return np.mean(rows, axis=0)


def _masked(msg, names):
    for tid, name in names.items():
        msg = msg.replace(tid, name)
    return msg


def _run_flow(kind, tmp_path):
    """The promotion flow on one platform; returns what the test
    compares: answers, response keys, bins, errors, cache events."""
    if kind == "port":
        ff, cache_cls = ("rafiki_torch.models.feedforward:"
                         "TorchFeedForward"), Cache
    else:
        from rafiki_tpu.cache import Cache as RefCache

        ff, cache_cls = "rafiki_tpu.models.feedforward:JaxFeedForward", \
            RefCache
    imgs = np.random.default_rng(7).integers(
        0, 256, (3, *SHAPE)).astype(np.uint8)
    platform = _platform(kind, tmp_path / kind)
    out = {"keys": [], "errors": []}
    try:
        dev, job, ids = _seed_job(platform, ff, "ff-promote", 5,
                                  statuses={4: "RUNNING"})
        _, _, foreign = _seed_job(platform, ff, "ff-other", 1)
        names = {t: f"<t{i}>" for i, t in enumerate(ids)}
        names[foreign[0]] = "<foreign>"
        names[job["id"]] = "<train-job>"
        inf = platform.admin.create_inference_job(dev["id"], job["id"],
                                                  max_models=2)
        names[inf["id"]] = "<job>"
        _wait_registered(platform, inf["id"], cache_cls, 1)
        info = cache_cls(platform.bus).running_worker_info(inf["id"])
        out["stacked"] = [i.get("stacked") for i in info.values()]
        out["bins0"] = _bins(platform, inf["id"], cache_cls, names)
        host = platform.admin.get_inference_job(inf["id"])[
            "predictor_host"]
        out["answers"] = [_predict(host, imgs), _predict(host, imgs)]
        out["events"] = [dict(_events(platform))]
        n_services = len(platform.meta.get_services())

        # The surgical promote, through the REST route.
        token = _login(platform.admin_port)
        status, res = _call(platform.admin_port, "POST",
                            f"/inference_jobs/{inf['id']}/promote", token,
                            {"trial_id": ids[2], "replace_trial_id": ids[1]})
        assert status == 200, res
        out["keys"].append(sorted(res))
        out["restacked"] = len(res["restacked_service_ids"])
        out["bins1"] = _bins(platform, inf["id"], cache_cls, names)
        out["new_services_after_restack"] = \
            len(platform.meta.get_services()) - n_services
        out["answers"].append(_predict(host, imgs))
        out["events"].append(dict(_events(platform)))

        # The additive promote.
        res = platform.admin.promote_trial(inf["id"], ids[3])
        out["keys"].append(sorted(res))
        out["bins2"] = _bins(platform, inf["id"], cache_cls, names)
        out["answers"].append(_predict(host, imgs))
        out["events"].append(dict(_events(platform)))

        # Validation, in the reference's words.
        for args, kw in (((inf["id"], "no-such-trial"), {}),
                         ((inf["id"], ids[3]), {}),
                         ((inf["id"], ids[4]), {}),
                         ((inf["id"], foreign[0]), {}),
                         ((inf["id"], ids[1]),
                          {"replace_trial_id": "nope"})):
            try:
                platform.admin.promote_trial(*args, **kw)
                out["errors"].append(None)
            except ValueError as e:
                out["errors"].append(_masked(str(e), names))
        status, res = _call(platform.admin_port, "POST",
                            f"/inference_jobs/{inf['id']}/promote", token,
                            {"replace_trial_id": ids[1]})
        out["errors"].append((status, sorted(res)))
        platform.admin.stop_inference_job(inf["id"])
    finally:
        platform.shutdown()
    return out, imgs


def _flow_fixture(kind, tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RAFIKI_TPU_SERVING_CACHE_BYTES", str(8 << 20))
        mp.setenv("RAFIKI_TPU_SERVING_CACHE_ADMIT_AFTER", "1")
        return _run_flow(kind, tmp_path_factory.mktemp(kind))


@pytest.fixture(scope="module")
def port_flow(tmp_path_factory):
    return _flow_fixture("port", tmp_path_factory)


@pytest.fixture(scope="module")
def ref_flow(tmp_path_factory):
    return _flow_fixture("ref", tmp_path_factory)


def test_promotions_restack_in_place_and_leave_no_stale_answer(port_flow):
    """A stacked 2-member bin, restacked in place (no new service), then
    a second bin; every answer the mean of the served members' own
    predictions, and no cached answer survives a promote."""
    port, imgs = port_flow
    assert port["stacked"] == [True]
    assert port["bins0"] == ["<t0>,<t1>"]
    assert port["bins1"] == ["<t0>,<t2>"] and port["restacked"] == 1
    assert port["new_services_after_restack"] == 0
    assert port["bins2"] == ["<t0>,<t2>", "<t3>"]
    want = [_own_mean((0, 1), imgs), _own_mean((0, 1), imgs),
            _own_mean((0, 2), imgs), _own_mean((0, 2, 3), imgs)]
    for got, exp in zip(port["answers"], want):
        assert float(np.abs(got - exp).max()) <= TOL_MEAN
    misses = [e.get("miss", 0) for e in port["events"]]
    hits = [e.get("hit", 0) for e in port["events"]]
    assert misses == [3, 6, 9] and hits == [3, 3, 3]
    assert port["events"][-1]["invalidate"] >= 2


def test_promotion_flow_equals_the_reference(port_flow, ref_flow):
    """The same calls on the reference: the same bins, response keys,
    validation errors and cache events, and answers within a bf16
    ulp."""
    port, ref = port_flow[0], ref_flow[0]
    for key in ("stacked", "bins0", "bins1", "bins2", "restacked",
                "new_services_after_restack", "keys", "errors", "events"):
        assert port[key] == ref[key], key
    assert port["errors"][:4] == [
        "unknown trial no-such-trial",
        "trial <t3> is already served by this job",
        "trial <t4> is not COMPLETED with saved params",
        "trial <foreign> does not belong to train job <train-job>"]
    for got, exp in zip(port["answers"], ref["answers"]):
        assert float(np.abs(got - exp).max()) <= TOL_JAX


# --- The ViT restack at 2 blocks -------------------------------------

VIT_KNOBS = {"d_model": 32, "n_heads": 2, "patch": 4, "depth": 2}
VIT_SHAPE = (8, 8, 3)
# The port against the reference in f32 (tests/test_torch_stacked.py).
PROB_ATOL = 3.9e-3


def _vit_params(seed):
    """Seeded ViT parameters (the port's initialisation, perturbed so no
    bias or scale is trivial) in the reference's flat names."""
    from rafiki_torch.model.bridge import dense_to_jax
    from rafiki_torch.models.vit import _ViT

    net = _ViT(3, N_CLASSES, 32, 2, 4, 5, seed=seed)
    p = {k: np.asarray(v, np.float32)
         for k, v in dense_to_jax(net.state_dict()).items()}
    rng = np.random.default_rng(seed)
    for k in p:
        if k.endswith(("/scale", "/bias")) or k == "params/cls":
            p[k] = (p[k] + 0.1 * rng.standard_normal(p[k].shape)).astype(
                np.float32)
    p["_meta/n_classes"] = np.asarray(N_CLASSES)
    p["_meta/image_shape"] = np.asarray(VIT_SHAPE)
    return p


def _member_rows(group, imgs):
    """Every member's rows of a stacked group, one staged dispatch."""
    n = imgs.shape[0]
    buf = np.zeros((group.predict_bucket(n, imgs.dtype), *imgs.shape[1:]),
                   imgs.dtype)
    buf[:n] = imgs
    fins = group.member_finishers([group.staged_submit(buf, n)])
    return np.stack([np.asarray(f()) for f in fins])


def test_vit_restack_matches_a_fresh_bin_and_the_reference(monkeypatch):
    import jax
    import jax.numpy as jnp
    import torch

    from rafiki_torch.model.stacked import stack_members
    from rafiki_torch.models import TorchViT, layers
    from rafiki_tpu.model.jax_model import stack_members as ref_stack
    from rafiki_tpu.models.vit import JaxViT
    from rafiki_tpu.parallel.mesh import build_mesh

    class JaxViT32(JaxViT):
        def create_module(self, n_classes, image_shape):
            return super().create_module(n_classes, image_shape).clone(
                dtype=jnp.float32)

    monkeypatch.setattr(layers, "COMPUTE", torch.float32)

    def port(p):
        m = TorchViT(device="cpu", **VIT_KNOBS)
        m.load_parameters(p)
        return m

    def ref(p):
        m = JaxViT32(**VIT_KNOBS)
        m._mesh = build_mesh(jax.devices()[:1])
        m.load_parameters(p)
        return m

    params = [_vit_params(s) for s in range(3)]
    imgs = np.random.default_rng(3).integers(
        0, 256, (5, *VIT_SHAPE)).astype(np.uint8)
    group = stack_members([port(params[0]), port(params[1])])
    assert group is not None
    _member_rows(group, imgs)  # the runner is built before the swap
    group.update_member(1, port(params[2]))
    restacked = _member_rows(group, imgs)
    fresh = _member_rows(stack_members([port(params[0]), port(params[2])]),
                         imgs)
    assert float(np.abs(restacked - fresh).max()) <= TOL_MEAN
    rgroup = ref_stack([ref(params[0]), ref(params[2])])
    assert rgroup is not None
    assert float(np.abs(restacked - _member_rows(rgroup, imgs)).max()) \
        <= PROB_ATOL
