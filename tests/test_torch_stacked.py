"""Ensemble serving of the port against the JAX package on the CPU:
stacked members, bucketed and staged predict, int8 serving and the
workers that serve them.

Members are initialised, not trained, as ``tests/test_stacked.py`` makes
the reference's (serving needs loaded weights): the port's module from a
seed, carried to the reference's layout by the bridge, and both sides
load that parameter file, so they hold the same weights. Sizes:
``TorchFeedForward`` on 8×8×1 images, DenseNet's ``densenet_tiny``
preset (blocks 2/2/2) at growth 8 and ``TinyEnas`` (2 blocks, 3 cells of
8 channels) on 8×8×3.
The reference runs on a one-device mesh, as the port's one card has no
data-parallel axis (its bucket ladder then starts at 1).

Tolerances. Stacked against per-member in f32: rtol 1e-3, atol 1e-4 (the
reference's, ``tests/test_stacked.py``); on the CPU FeedForward and
DenseNet are in fact bit for bit. ENAS's ``GroupNorm`` reduces its
vmapped batch in another order than a single member's, so one activation
in bf16 may land on the neighbouring value: there the bound is
``PROB_ATOL``, one bf16 ulp of a logit below 4 (3.9e-3), as the zoo's
parity tests hold the port against the reference. Under int8, 2e-2 (the
reference's envelope). The port against the reference: ``PROB_ATOL`` in
f32 (bf16 products in another order), 2e-2 under int8.
``dynamic_int8_matmul``: the int8 operands and int32 products are exact,
the f32 rescale within 1e-6 relative.
"""

import _torch_threads  # noqa: F401  (caps torch threads under xdist)
import contextlib
import functools
import gc
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rafiki_tpu.model import jax_model as ref_jm
from rafiki_tpu.models.densenet import JaxDenseNet
from rafiki_tpu.models.enas import JaxEnas
from rafiki_tpu.models.feedforward import JaxFeedForward
from rafiki_tpu.parallel.mesh import build_mesh
from rafiki_torch import torchenv
from rafiki_torch.bus import MemoryBus
from rafiki_torch.cache import (WIRE_NDBATCH, Cache, PackedBatch,
                                encode_payload)
from rafiki_torch.model import torch_model as tm_mod
from rafiki_torch.model.bridge import dense_to_jax
from rafiki_torch.model.stacked import StackedMembers
from rafiki_torch.model.torch_model import (dynamic_int8_matmul,
                                           stack_congruence, stack_members)
from rafiki_torch.models import TorchDenseNet, TorchEnas, TorchFeedForward
from rafiki_torch.observe import wire
from rafiki_torch.store import MetaStore, ParamStore
from rafiki_torch.worker.inference import BusInferenceWorker, _PackedEnsemble

FF_SHAPE = (8, 8, 1)
CONV_SHAPE = (8, 8, 3)
N_CLASSES = 4
PROB_ATOL = 3.9e-3
INT8_ATOL = 2e-2
FF_KNOBS = [{"hidden_layer_count": 2, "hidden_layer_units": 32},
            {"hidden_layer_count": 1, "hidden_layer_units": 16},
            {"hidden_layer_count": 3, "hidden_layer_units": 64}]


class JaxTinyEnas(JaxEnas):
    n_blocks = 2
    full_cells, full_channels = 3, 8
    search_cells, search_channels = 3, 8


class TorchTinyEnas(TorchEnas):
    n_blocks = 2
    full_cells, full_channels = 3, 8
    search_cells, search_channels = 3, 8


def _arch(seed):
    rng = np.random.default_rng(seed)
    a = []
    for _ in range(2):
        for b in range(2):
            a += [int(rng.integers(b + 2)), int(rng.integers(5)),
                  int(rng.integers(b + 2)), int(rng.integers(5))]
    return a


FAMILIES = {
    "ff": (JaxFeedForward, TorchFeedForward, FF_SHAPE),
    "densenet": (JaxDenseNet, TorchDenseNet, CONV_SHAPE),
    "enas": (JaxTinyEnas, TorchTinyEnas, CONV_SHAPE),
}


def _knobs(family, i, **over):
    if family == "ff":
        k = dict(FF_KNOBS[i % len(FF_KNOBS)])
    elif family == "densenet":
        k = {"arch": "densenet_tiny", "growth_rate": 8}
    else:
        k = {"arch": _arch(i), "share_params": True}
    k.update(over)
    return k


@functools.lru_cache(maxsize=None)
def _params(family, seed, knob_items, n_classes=N_CLASSES):
    """A member's parameter file: the port's module initialised from
    ``seed``, in the reference's layout (the bridge), its norms and
    running statistics jittered so that they matter."""
    _, tcls, shape = FAMILIES[family]
    knobs = {k: list(v) if isinstance(v, tuple) else v
             for k, v in knob_items}
    net = tcls(device="cpu", seed=seed, **knobs).create_module(n_classes,
                                                                shape)
    flat = dense_to_jax(net.state_dict())
    rng = np.random.default_rng(seed)
    for k, v in flat.items():
        if k.endswith(("/scale", "/var")):
            flat[k] = (1 + 0.2 * rng.random(v.shape)).astype(np.float32)
        elif k.endswith("/mean") or (k.endswith("/bias")
                                     and family != "ff"):
            flat[k] = (0.1 * rng.standard_normal(v.shape)).astype(
                np.float32)
    flat["_meta/n_classes"] = np.asarray(n_classes)
    flat["_meta/image_shape"] = np.asarray(shape)
    return flat


def _items(knobs):
    return tuple(sorted((k, tuple(v) if isinstance(v, list) else v)
                        for k, v in knobs.items()))


def _pair(family, seed, n_classes=N_CLASSES, **over):
    """The reference's member and the port's, on the same parameters."""
    jcls, tcls, _ = FAMILIES[family]
    knobs = _knobs(family, seed, **over)
    p = _params(family, seed, _items(knobs), n_classes)
    jm = jcls(**knobs)
    jm._mesh = build_mesh(jax.devices()[:1])
    jm.load_parameters(p)
    tm = tcls(device="cpu", **knobs)
    tm.load_parameters(p)
    return jm, tm


def _queries(shape, n=5, seed=0):
    return (np.random.default_rng(seed).random((n, *shape)) * 255).astype(
        np.uint8)


def _stacked_rows(st, q, member):
    bucket = st.predict_bucket(q.shape[0], q.dtype)
    buf = np.zeros((bucket, *q.shape[1:]), q.dtype)
    buf[:q.shape[0]] = q
    return np.asarray(st.member_finishers([st.staged_submit(
        buf, q.shape[0])])[member]())


def _torch_reason(reason):
    return None if reason is None else reason.replace("Jax", "Torch")


# --- Congruence: the port's verdicts are the reference's ---


def _set_ff_three():
    return [_pair("ff", i) for i in range(3)]


def _set_ff_densenet():
    return [_pair("ff", 0), _pair("densenet", 1)]


def _set_densenet_growths():
    return [_pair("densenet", 0), _pair("densenet", 1, growth_rate=12)]


def _set_one_member():
    return [_pair("ff", 0)]


def _set_quant_modes():
    pairs = [_pair("ff", 0), _pair("ff", 1)]
    for m in pairs[1]:
        m.enable_serving_quant("int8")
    return pairs


def _set_enas_supernets():
    return [_pair("enas", 0), _pair("enas", 1)]


def _set_ff_classes():
    return [_pair("ff", 0), _pair("ff", 1, n_classes=7)]


@pytest.mark.parametrize("make,stacks", [
    (_set_ff_three, True), (_set_ff_densenet, False),
    (_set_densenet_growths, False), (_set_one_member, False),
    (_set_quant_modes, False), (_set_enas_supernets, True),
    (_set_ff_classes, False)])
def test_congruence_verdicts_match_the_reference(make, stacks):
    pairs = make()
    ref = ref_jm.stack_congruence([j for j, _ in pairs])
    got = stack_congruence([t for _, t in pairs])
    assert (got is None) == stacks
    assert got == _torch_reason(ref)


# --- BatchNorm over stacked members: flax's eval formula ---


def test_stacked_batchnorm_is_flax_eval_batchnorm():
    from flax import linen as fnn
    from torch.func import functional_call, stack_module_state, vmap

    from rafiki_torch.models.layers import BatchNorm

    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 6, 5, 5)).astype(np.float32)
    bns, refs = [], []
    for _ in range(2):
        scale, bias, mean = (rng.standard_normal(6).astype(np.float32)
                             for _ in range(3))
        var = (0.5 + rng.random(6)).astype(np.float32)
        bn = BatchNorm(6).eval()
        bn.load_state_dict({"weight": torch.from_numpy(scale),
                            "bias": torch.from_numpy(bias),
                            "running_mean": torch.from_numpy(mean),
                            "running_var": torch.from_numpy(var)})
        bns.append(bn)
        flax_bn = fnn.BatchNorm(use_running_average=True, momentum=0.9,
                                epsilon=1e-5, dtype=jnp.float32)
        refs.append(np.asarray(flax_bn.apply(
            {"params": {"scale": scale, "bias": bias},
             "batch_stats": {"mean": mean, "var": var}},
            jnp.asarray(x.transpose(0, 2, 3, 1)))).transpose(0, 3, 1, 2))
    params, bufs = stack_module_state(bns)
    out = vmap(lambda s, x: functional_call(bns[0], s, (x,)),
               in_dims=(0, None))({**params, **bufs}, torch.from_numpy(x))
    for i in range(2):
        np.testing.assert_allclose(out[i].detach().numpy(), refs[i],
                                   rtol=1e-6, atol=1e-6)


# --- Quantisation: the reference's int8 weights, byte for byte ---


@pytest.mark.parametrize("family", ["ff", "densenet"])
def test_int8_weights_scales_and_report_match_the_reference(family):
    jm, tm = _pair(family, 0)
    assert tm.enable_serving_quant("int8") == jm.enable_serving_quant("int8")
    jq, js, jf, jl = jm._quant_host_arrays()
    tq, ts, tf, tl = tm._quant_host_arrays()
    assert tl == jl and set(tq) == set(jq) and set(tf) == set(jf)
    n4 = 0
    for k in jq:
        assert tq[k].dtype == np.int8 and ts[k].dtype == np.float32
        assert tq[k].tobytes() == np.asarray(jq[k]).tobytes(), k
        assert ts[k].tobytes() == np.asarray(js[k]).tobytes(), k
        n4 += tq[k].ndim == 4
    assert n4 > 0 if family == "densenet" else n4 == 0
    for k in jf:
        np.testing.assert_array_equal(tf[k], jf[k])
    assert tm.enable_serving_quant("") == {"mode": None, "layers": {}}
    assert tm.quant_report() == {"mode": None, "layers": {}}
    with pytest.raises(ValueError, match="unsupported serving quant"):
        tm.enable_serving_quant("int4")


@pytest.mark.parametrize("m,k,n", [(1, 64, 10), (5, 64, 10), (33, 72, 128),
                                   (17, 784, 16)])
def test_dynamic_int8_matmul_matches_the_reference(m, k, n):
    rng = np.random.default_rng(m * 1000 + k)
    x = rng.standard_normal((m, k)).astype(np.float32)
    x[0] = 0.0  # a zero row takes the 1e-8 clamp
    w = rng.integers(-127, 128, (k, n), dtype=np.int8)
    s = (rng.random(n) * 0.05 + 1e-3).astype(np.float32)
    ref = np.asarray(ref_jm.dynamic_int8_matmul(jnp.asarray(x),
                                                jnp.asarray(w),
                                                jnp.asarray(s)))
    got = dynamic_int8_matmul(torch.from_numpy(x), torch.from_numpy(w),
                              torch.from_numpy(s)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=0)


# --- Buckets and staged predict ---


def test_predict_bucket_matches_the_reference():
    jm, tm = _pair("ff", 0)
    for dtype in (np.uint8, np.float32, np.float16):
        for n in range(0, 514):
            assert tm.predict_bucket(n, dtype) == jm.predict_bucket(n, dtype)
    assert tm.predict_bucket(3, np.float32) == 4
    assert tm.predict_bucket(512, np.uint8) == 512
    fresh = TorchFeedForward(device="cpu", **FF_KNOBS[0])
    assert fresh.predict_bucket(1) is None


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_staged_predict_with_stale_padding_equals_predict_proba(dtype):
    _, tm = _pair("ff", 0)
    q = _queries(FF_SHAPE, n=5)
    if dtype == np.float32:
        q = q.astype(np.float32) / 255.0
    bucket = tm.predict_bucket(5, dtype)
    assert bucket == 8
    buf = np.full((bucket, *FF_SHAPE), 200, dtype)  # stale rows
    buf[:5] = q
    got = np.asarray(tm.predict_staged_submit(buf, 5)())
    np.testing.assert_array_equal(got, tm.predict_proba(q))
    flat = buf.reshape(bucket, -1)  # rows of the right size reshape
    np.testing.assert_array_equal(
        np.asarray(tm.predict_staged_submit(flat, 5)()), got)
    with pytest.raises(ValueError, match="bucket"):
        tm.predict_staged_submit(buf[:4], 5)
    with pytest.raises(ValueError, match="staged rows"):
        tm.predict_staged_submit(np.zeros((8, 3, 3, 1), dtype), 5)
    assert len({k[0] for k in tm._runners.runners}) == 1


# --- Stacked rows ---


@pytest.mark.parametrize("family,quant", [
    ("ff", None), ("ff", "int8"), ("densenet", None), ("densenet", "int8"),
    ("enas", None)])
def test_stacked_rows_match_each_members_own_predict(family, quant):
    ms = [_pair(family, i)[1] for i in range(3 if family == "ff" else 2)]
    if quant:
        for m in ms:
            m.enable_serving_quant(quant)
    st = stack_members(ms)
    assert isinstance(st, StackedMembers) and st.n_members == len(ms)
    q = _queries(ms[0]._meta["image_shape"])
    if quant:
        tol = dict(rtol=1e-3, atol=INT8_ATOL)
    elif family == "enas":
        tol = dict(rtol=0, atol=PROB_ATOL)
    else:
        tol = dict(rtol=1e-3, atol=1e-4)
    for i, m in enumerate(ms):
        np.testing.assert_allclose(_stacked_rows(st, q, i),
                                   m.predict_proba(q), **tol)


@pytest.mark.parametrize("quant", [None, "int8"])
def test_stacked_rows_match_the_references_stacked_members(quant):
    pairs = [_pair("ff", i) for i in range(3)]
    if quant:
        for jm, tm in pairs:
            jm.enable_serving_quant(quant)
            tm.enable_serving_quant(quant)
    ref = ref_jm.stack_members([j for j, _ in pairs])
    got = stack_members([t for _, t in pairs])
    q = _queries(FF_SHAPE, n=7, seed=3)
    atol = INT8_ATOL if quant else PROB_ATOL
    for i in range(3):
        np.testing.assert_allclose(_stacked_rows(got, q, i),
                                   _stacked_rows(ref, q, i), rtol=0,
                                   atol=atol)


# --- The packed ensemble ---


def _count_dispatches(monkeypatch, ens, q):
    from rafiki_torch.model import stacked as st_mod

    calls = {"member": 0, "stacked": 0}
    member = tm_mod.TorchModel._dispatch_bucket
    stacked = st_mod.StackedMembers._dispatch

    def member_spy(self, chunk, n):
        calls["member"] += 1
        return member(self, chunk, n)

    def stacked_spy(self, chunk):
        calls["stacked"] += 1
        return stacked(self, chunk)

    monkeypatch.setattr(tm_mod.TorchModel, "_dispatch_bucket", member_spy)
    monkeypatch.setattr(st_mod.StackedMembers, "_dispatch", stacked_spy)
    bucket = ens.predict_bucket(q.shape[0], q.dtype)
    buf = np.zeros((bucket, *q.shape[1:]), q.dtype)
    buf[:q.shape[0]] = q
    preds = ens.predict_staged_submit(buf, q.shape[0])()
    queried = ens.predict(list(q))
    monkeypatch.undo()
    return calls, preds, queried


def test_a_stacked_burst_is_one_dispatch_a_per_member_one_is_n(monkeypatch):
    ms = [_pair("ff", i)[1] for i in range(3)]
    q = _queries(FF_SHAPE)
    per = _PackedEnsemble(list(ms))
    calls_pm, preds_pm, q_pm = _count_dispatches(monkeypatch, per, q)
    assert calls_pm == {"member": 6, "stacked": 0}
    assert per.last_mode == "members"
    assert per.dispatches == {"stacked": 0, "fallback": 0, "members": 6}
    st = _PackedEnsemble(list(ms), stacked=stack_members(ms))
    calls_st, preds_st, q_st = _count_dispatches(monkeypatch, st, q)
    assert calls_st == {"member": 0, "stacked": 2}
    assert st.last_mode == "stacked"
    assert st.dispatches == {"stacked": 2, "fallback": 0, "members": 0}
    assert st.bursts["stacked"] == 2
    own = np.mean(np.asarray([m.predict_proba(q) for m in ms], np.float64),
                  axis=0)
    for got in (preds_st, q_st, preds_pm, q_pm):
        np.testing.assert_allclose(got, own, rtol=1e-6, atol=1e-7)


def test_a_failing_stacked_dispatch_serves_per_member(monkeypatch, caplog):
    ms = [_pair("ff", i)[1] for i in range(2)]
    ens = _PackedEnsemble(list(ms), stacked=stack_members(ms))

    def boom(self, chunk):
        raise RuntimeError("stacked runner lost")

    monkeypatch.setattr(StackedMembers, "_dispatch", boom)
    q = _queries(FF_SHAPE, n=3)
    with caplog.at_level(logging.ERROR):
        out = ens.predict(list(q))
    assert ens.last_mode == "fallback" and ens.bursts["fallback"] == 1
    assert "serving this burst per-member" in caplog.text
    own = np.mean([m.predict_proba(q) for m in ms], axis=0)
    np.testing.assert_allclose(out, own, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("fails", [False, True])
def test_the_collector_is_off_for_a_capture(monkeypatch, fails):
    # A cycle the collector frees inside a capture may hold a CUDA graph,
    # whose destruction there breaks the capture; the collector comes
    # back on after it, whether the block raised or not.
    seen = []

    class FakeGraph:
        def __init__(self, graph, pool=None, stream=None,
                     capture_error_mode=None):
            assert capture_error_mode == "thread_local"

        def __enter__(self):
            seen.append(gc.isenabled())

        def __exit__(self, *exc):
            seen.append(gc.isenabled())

    monkeypatch.setattr(torch.cuda, "graph", FakeGraph)
    assert gc.isenabled()
    with pytest.raises(RuntimeError) if fails else contextlib.nullcontext():
        with torchenv.graph_capture(object()):
            seen.append(gc.isenabled())
            if fails:
                raise RuntimeError("capture broken")
    assert seen == [False, False, False] and gc.isenabled()


def test_a_failed_capture_hands_the_next_runner_a_fresh_pool(monkeypatch):
    # A failed capture leaves its pool marked as recording, where every
    # later capture would raise.
    handles = iter(range(100))
    monkeypatch.setattr(torch.cuda, "graph_pool_handle",
                        lambda: ("pool", next(handles)))
    pools = []

    class FakeRunner:
        graph = object()

        def __init__(self, fn, shape, dtype, device, pool):
            pools.append(pool)
            fn()

        def __call__(self, x):
            return x

    monkeypatch.setattr(tm_mod, "PredictRunner", FakeRunner)
    runners = tm_mod.PredictRunners(torch.device("cuda"))
    x = torch.zeros(2)

    def broken():
        raise RuntimeError("operation not permitted when stream is capturing")

    runners.run("a", x, lambda: lambda: None)
    with pytest.raises(RuntimeError):
        runners.run("b", x, lambda: broken)
    runners.run("b", x, lambda: lambda: None)
    runners.run("c", x, lambda: lambda: None)
    assert pools == [("pool", 0), ("pool", 0), ("pool", 1), ("pool", 1)]
    assert runners.captures == 3 and sorted(runners.runners) == ["a", "b", "c"]


def test_the_validity_mask_drops_only_the_invalid_vote():
    ms = [_pair("ff", i)[1] for i in range(3)]
    st = stack_members(ms)
    ens = _PackedEnsemble(list(ms), stacked=st)
    q = _queries(FF_SHAPE)
    rows = [_stacked_rows(st, q, i) for i in range(3)]
    st.valid[1] = False
    out = np.asarray(ens.predict(list(q)))
    assert ens.last_weight == 2
    np.testing.assert_allclose(
        out, np.mean(np.asarray([rows[0], rows[2]], np.float64), axis=0),
        rtol=1e-12, atol=0)


@pytest.mark.parametrize("quant", [None, "int8"])
def test_replace_member_restacks_one_member_in_place(quant):
    ms = [_pair("ff", i)[1] for i in range(3)]
    incoming = _pair("ff", 7, **FF_KNOBS[2])[1]
    for m in ms + [incoming]:
        m.enable_serving_quant(quant)
    st = stack_members(ms)
    ens = _PackedEnsemble(list(ms), stacked=st)
    q = _queries(FF_SHAPE)
    before = [_stacked_rows(st, q, i) for i in range(3)]
    storage = {k: v.data_ptr() for k, v in
               (st._vars["q"] if quant else st._vars).items()}
    ens.replace_member(1, incoming)
    after = [_stacked_rows(st, q, i) for i in range(3)]
    np.testing.assert_array_equal(after[0], before[0])
    np.testing.assert_array_equal(after[2], before[2])
    tol = dict(rtol=1e-3, atol=INT8_ATOL) if quant else \
        dict(rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(after[1], incoming.predict_proba(q), **tol)
    assert not np.array_equal(after[1], before[1])
    assert ens.models[1] is incoming and st.models[1] is incoming
    assert {k: v.data_ptr() for k, v in
            (st._vars["q"] if quant else st._vars).items()} == storage


def test_an_incongruent_replacement_raises_before_any_state_changes():
    ms = [_pair("ff", i)[1] for i in range(2)]
    st = stack_members(ms)
    ens = _PackedEnsemble(list(ms), stacked=st)
    vars_before = {k: v.clone() for k, v in st._vars.items()}
    extra_before = {k: v.clone() for k, v in st._extra.items()}
    for bad in (_pair("densenet", 0)[1], _pair("ff", 3, n_classes=7)[1]):
        with pytest.raises(ValueError, match="not congruent"):
            ens.replace_member(0, bad)
    assert ens.models == ms and st.models == ms and st.valid == [True] * 2
    for k, v in st._vars.items():
        assert torch.equal(v, vars_before[k]), k
    for k, v in st._extra.items():
        assert torch.equal(v, extra_before[k]), k
    with pytest.raises(IndexError):
        st.update_member(5, ms[0])


# --- The two variables ---


@pytest.mark.parametrize("raw,want", [(None, ""), ("", ""), ("off", ""),
                                      (" INT8 ", "int8"), ("int4", "")])
def test_the_quant_variable(monkeypatch, caplog, raw, want):
    monkeypatch.delenv(wire.QUANT_ENV, raising=False)
    if raw is not None:
        monkeypatch.setenv(wire.QUANT_ENV, raw)
    with caplog.at_level(logging.WARNING):
        assert wire.quant_mode() == want
    assert ("failing safe" in caplog.text) == (raw == "int4")


@pytest.mark.parametrize("raw,want", [(None, True), ("", True), ("on", True),
                                      ("0", False), ("No", False),
                                      ("stacked", False)])
def test_the_stacked_variable(monkeypatch, caplog, raw, want):
    monkeypatch.delenv(wire.STACKED_ENV, raising=False)
    if raw is not None:
        monkeypatch.setenv(wire.STACKED_ENV, raw)
    with caplog.at_level(logging.WARNING):
        assert wire.stacked_mode() is want
    assert ("failing safe" in caplog.text) == (raw == "stacked")


# --- The bus worker ---


def _bin(tmp_path, n=2):
    meta = MetaStore(str(tmp_path / "meta.db"))
    params = ParamStore(str(tmp_path / "params"))
    user = meta.create_user("d@x.c", "-", "MODEL_DEVELOPER")
    model = meta.create_model(
        user["id"], "ff", "IMAGE_CLASSIFICATION",
        "rafiki_torch.models.feedforward:TorchFeedForward", {})
    job = meta.create_train_job(user["id"], "a", "IMAGE_CLASSIFICATION", {},
                                "-", "-", "STOPPED")
    sub = meta.create_sub_train_job(job["id"], model["id"], "STOPPED")
    tids = []
    for i in range(n):
        knobs = _knobs("ff", i)
        p = _params("ff", i, _items(knobs))
        knobs.update(learning_rate=1e-3, batch_size=32, max_epochs=5)
        t = meta.create_trial(sub["id"], model["id"], i, "RUNNING",
                              knobs=knobs)
        meta.mark_trial_completed(t["id"], 0.5 + 0.1 * i,
                                  params.save(p, session_id="s"))
        tids.append(t["id"])
    inf = meta.create_inference_job(user["id"], job["id"], "RUNNING")
    svc = meta.create_service("INFERENCE", "DEPLOYING")
    return meta, params, inf["id"], svc["id"], ",".join(tids)


def _start(tmp_path, monkeypatch, **env):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    meta, params, inf, sid, tids = _bin(tmp_path)
    bus = MemoryBus()
    w = BusInferenceWorker(sid, inf, tids, meta, params, bus,
                           device="cpu").start()
    cache = Cache(bus)
    for _ in range(600):
        if sid in cache.running_workers(inf):
            break
        w._thread.join(0.05)
    info = cache.running_worker_info(inf)[sid]
    return w, cache, bus, info


def test_a_bus_worker_stacks_its_bin_and_stages_packed_bursts(
        tmp_path, monkeypatch):
    monkeypatch.delenv(wire.STACKED_ENV, raising=False)
    w, cache, bus, info = _start(tmp_path, monkeypatch)
    try:
        assert info["stacked"] is True and info["quant"] is None
        assert info["staging"] == "pageable"
        ens = w.model
        assert ens.stacked is not None and ens.stacked.n_members == 2
        q = _queries(FF_SHAPE, n=3)
        frame = PackedBatch.from_arrays(list(q)).slice(0, 3)
        bus.push(f"q:{w.service_id}", {"batch_id": "b1", "shard": "s",
                                       "batch": frame,
                                       "rw": [WIRE_NDBATCH]})
        (reply,) = cache.gather_prediction_batches("b1", 1, timeout=30)
        assert ens.bursts == {"stacked": 1, "fallback": 0, "members": 0}
        assert ens.dispatches["stacked"] == 1
        assert len(w._stager._bufs) == 1  # the staged path
        rows = [_stacked_rows(ens.stacked, q, i) for i in range(2)]
        np.testing.assert_allclose(
            np.asarray(reply["predictions"], np.float64),
            np.mean(np.asarray(rows, np.float64), axis=0), rtol=0,
            atol=1e-7)
        assert reply["weight"] == 2
        # Queries as objects take predict, still one stacked dispatch.
        bus.push(f"q:{w.service_id}",
                 {"batch_id": "b2", "shard": "s",
                  "queries": [encode_payload(x) for x in q]})
        (reply2,) = cache.gather_prediction_batches("b2", 1, timeout=30)
        assert ens.bursts["stacked"] == 2 and len(w._stager._bufs) == 1
        np.testing.assert_allclose(reply2["predictions"],
                                   reply["predictions"], atol=1e-6)
    finally:
        w.stop()


def test_a_bus_worker_with_unknown_spellings_serves_plain(tmp_path,
                                                          monkeypatch):
    w, cache, bus, info = _start(
        tmp_path, monkeypatch,
        **{wire.STACKED_ENV: "sometimes", wire.QUANT_ENV: "int3"})
    try:
        assert info["stacked"] is False and info["quant"] is None
        assert w.model.stacked is None
        assert all(m._quant_mode is None for m in w.model.models)
    finally:
        w.stop()


def test_a_bus_worker_serves_int8_when_asked(tmp_path, monkeypatch):
    monkeypatch.delenv(wire.STACKED_ENV, raising=False)
    w, cache, bus, info = _start(tmp_path, monkeypatch,
                                 **{wire.QUANT_ENV: "int8"})
    try:
        assert info["quant"] == "int8" and info["stacked"] is True
        assert all(m.quant_report()["n_int8"] == 4 for m in w.model.models)
        assert w.model.stacked._quant == "int8"
    finally:
        w.stop()
