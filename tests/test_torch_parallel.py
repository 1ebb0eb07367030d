"""The port's mesh, placement, transfer, MoE and pipeline against the
reference's, on the CPU.

The reference runs on its 8 virtual CPU devices (``tests/conftest.py``);
the port's mesh names the CPU once an entry. Inputs come from a numpy
seed. Tolerances: float32 values within 1e-5 absolute and relative
(sums in another order), gradients within 1e-4; a placement, a shape,
a dtype or a round trip is held exactly.
"""

import _torch_threads  # noqa: F401  (caps torch threads under xdist)
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from rafiki_torch.ops import pipeline_apply, pipelined, switch_moe
from rafiki_torch.parallel import (ChipGroup, HostStager, build_mesh,
                                   batch_sharding, device_get_tree,
                                   discover_topology, make_host_stager,
                                   param_spec, replicated, shard_variables,
                                   variables_shardings)
from rafiki_torch.parallel import transfer
from rafiki_tpu.jaxcompat import shard_map
from rafiki_tpu.ops import pipelined as jax_pipelined
from rafiki_tpu.ops import switch_moe as jax_switch_moe
from rafiki_tpu.parallel import build_mesh as jax_build_mesh
from rafiki_tpu.parallel import param_spec as jax_param_spec

CPU = torch.device("cpu")


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


# --- ChipGroup ---------------------------------------------------------


def test_a_group_s_devices_bind_to_its_thread_only():
    g = ChipGroup(indices=(0, 0, 0), device_type="cpu")
    assert g.devices() == [CPU] * 3 and g.device == CPU
    assert ChipGroup(indices=(2, 3)).devices() == [torch.device("cuda", 2),
                                                    torch.device("cuda", 3)]
    assert ChipGroup.bound() is None
    seen = {}

    def other():
        seen["other"] = ChipGroup.bound()

    g.bind_to_thread()
    try:
        assert ChipGroup.current() is g and ChipGroup.bound() is g
        t = threading.Thread(target=other)
        t.start()
        t.join()
        assert seen["other"] is None
    finally:
        ChipGroup.unbind_thread()
    assert ChipGroup.bound() is None


def test_the_environment_s_group_comes_after_the_thread_s(monkeypatch):
    monkeypatch.setenv("RAFIKI_TPU_CHIPS", "0,1")
    monkeypatch.setenv("RAFIKI_TPU_PLATFORM", "cpu")
    assert ChipGroup.current().devices() == [CPU, CPU]
    g = ChipGroup(indices=(0,), device_type="cpu")
    g.bind_to_thread()
    try:
        assert ChipGroup.current() is g
    finally:
        ChipGroup.unbind_thread()


def test_without_a_group_or_a_card_current_raises(monkeypatch):
    monkeypatch.delenv("RAFIKI_TPU_CHIPS", raising=False)
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ChipGroup.current()


def test_discover_topology_is_none_without_coords():
    from rafiki_tpu.parallel.chips import discover_topology as jax_topo

    assert jax_topo(jax.devices()) is None
    assert discover_topology([CPU, CPU]) is None
    assert discover_topology([torch.device("cuda", 0)]) is None


# --- Mesh and placement ------------------------------------------------


@pytest.mark.parametrize("kw", [dict(tp=2), dict(), dict(sp=2),
                                dict(sp=2, ep=2), dict(pp=2, ep=2),
                                dict(pp=8)])
def test_build_mesh_shapes_match_the_reference(kw):
    want = jax_build_mesh(jax.devices(), **kw)
    got = build_mesh([CPU] * 8, **kw)
    assert dict(got.shape) == dict(want.shape)
    assert got.devices.shape == want.devices.shape
    assert build_mesh([CPU] * 8, **kw) is got  # interned
    assert got.distinct() == 1 and got.size == 8


def test_build_mesh_refuses_an_indivisible_count():
    with pytest.raises(ValueError, match="not divisible by pp\\*ep\\*sp\\*tp=3"):
        build_mesh([CPU] * 8, tp=3)
    with pytest.raises(ValueError, match="1 devices not divisible"):
        build_mesh([CPU], sp=2)


def test_the_mesh_orders_its_devices_as_the_reference():
    """Entry (dp, pp, ep, sp, tp) is device number of its row-major
    index: tp fastest, then sp."""
    devs = [torch.device("cuda", i) for i in range(8)]
    mesh = build_mesh(devs, sp=2, pp=2)
    want = jax_build_mesh(jax.devices(), sp=2, pp=2)
    ids = np.vectorize(lambda d: d.index)(mesh.devices)
    np.testing.assert_array_equal(ids, np.vectorize(lambda d: d.id)(
        want.devices))


PARAM_TABLE = [
    ("dense/kernel", (128, 512), dict(tp=2)),
    ("dense/kernel", (16, 8), dict(tp=2)),
    ("dense/bias", (512,), dict(tp=2)),
    ("dense/kernel", (128, 512), dict(tp=1)),
    ("dense/kernel", (128, 200), dict(tp=2)),
    ("block/expert_w1", (4, 8, 32), dict(tp=1, ep=2)),
    ("block/expert_w1", (3, 8, 32), dict(tp=1, ep=2)),
    ("block/moe_gate", (8, 4), dict(tp=1, ep=2)),
    ("stages/stage0/dense_0.weight", (2, 64, 32), dict(tp=1, pp=2)),
    ("stages/stage0/expert_w1", (2, 4, 8, 32), dict(tp=1, pp=2, ep=2)),
    ("stages/stage0/expert_w1", (2, 3, 8, 32), dict(tp=1, pp=2, ep=2)),
    ("stages/stage1/dense_0.weight", (4, 64, 32), dict(tp=1, pp=2)),
    ("outer/embed_0.weight", (2, 64), dict(tp=1, pp=2)),
]


@pytest.mark.parametrize("name,shape,kw", PARAM_TABLE)
def test_param_spec_follows_the_reference_s_rules(name, shape, kw):
    arr = np.zeros(shape, np.float32)
    want = tuple(jax_param_spec(arr, name=name, **kw))
    assert param_spec(torch.zeros(shape), name=name, **kw) == want


def test_shard_variables_cuts_each_coordinate_s_shard():
    mesh = build_mesh([CPU] * 8, pp=2, ep=2)
    rng = np.random.default_rng(0)
    tree = {"stages": {"stage0": {"expert_w1": _t(rng.standard_normal(
        (2, 4, 3, 5))), "dense.weight": _t(rng.standard_normal((2, 6)))}},
            "outer": {"embed": _t(rng.standard_normal((7, 3)))}}
    placed = shard_variables(tree, mesh)
    specs = variables_shardings(tree, mesh)
    assert specs["stages"]["stage0"]["expert_w1"].spec == ("pp", "ep", None,
                                                           None)
    assert specs["outer"]["embed"] == replicated(mesh)
    w = tree["stages"]["stage0"]["expert_w1"]
    for s in range(2):
        for e in range(2):
            shard = placed["stages"]["stage0"]["expert_w1"].at((1, s, e, 0, 0))
            assert torch.equal(shard, w[s:s + 1, 2 * e:2 * e + 2])
    emb = placed["outer"]["embed"].at((0, 1, 1, 0, 0))
    assert emb is tree["outer"]["embed"]  # replicated, same device
    assert batch_sharding(mesh).spec == ("dp",)


def test_a_replicated_leaf_sums_the_ranks_gradients():
    """Each dp rank's copy of one leaf: the leaf's grad is the sum of the
    ranks' (the psum over dp)."""
    mesh = build_mesh([CPU] * 4)
    w = torch.ones(3, requires_grad=True)
    placed = shard_variables({"w": w}, mesh)["w"]
    loss = sum((placed.at((i, 0, 0, 0, 0)) * (i + 1)).sum() for i in range(4))
    loss.backward()
    assert torch.equal(w.grad, torch.full((3,), 10.0))


# --- Transfer ----------------------------------------------------------


def test_device_get_tree_round_trip():
    tree = {"a": torch.arange(12, dtype=torch.float32).reshape(3, 4),
            "b": {"c": torch.ones((2, 2, 2), dtype=torch.float16) * 1.5,
                  "d": torch.tensor(7, dtype=torch.int32)},
            "host": np.arange(3),
            "e": [torch.full((5,), -2.0), torch.tensor([True, False])],
            "f": torch.ones(2, dtype=torch.bfloat16)}
    got = device_get_tree(tree)
    assert set(got) == set(tree) and isinstance(got["e"], list)
    for path, want in (("a", tree["a"]), ("c", tree["b"]["c"]),
                       ("d", tree["b"]["d"]), ("e0", tree["e"][0]),
                       ("e1", tree["e"][1])):
        g = {"a": got["a"], "c": got["b"]["c"], "d": got["b"]["d"],
             "e0": got["e"][0], "e1": got["e"][1]}[path]
        assert isinstance(g, np.ndarray)
        assert g.shape == tuple(want.shape) and g.dtype == want.numpy().dtype
        np.testing.assert_array_equal(g, want.numpy())
    np.testing.assert_array_equal(got["host"], np.arange(3))
    assert got["f"].dtype == np.float32  # numpy has no bfloat16
    np.testing.assert_array_equal(got["f"], np.ones(2, np.float32))


def test_device_get_tree_cache_keyed_on_device_leaf_mix():
    """Two trees of one structure whose tensor leaves coincide in shape
    and dtype but not in which leaves are tensors must not share a plan
    (ref tests/test_parallel.py:219-245)."""
    transfer._PACK_CACHE.clear()
    t1 = {"a": np.arange(4, dtype=np.float32), "b": torch.full((4,), 2.0)}
    g1 = device_get_tree(t1)
    np.testing.assert_array_equal(g1["a"], t1["a"])
    np.testing.assert_array_equal(g1["b"], np.full(4, 2.0, np.float32))
    t2 = {"a": torch.full((4,), 3.0), "b": np.arange(4, dtype=np.float32)}
    g2 = device_get_tree(t2)
    np.testing.assert_array_equal(g2["a"], np.full(4, 3.0, np.float32))
    np.testing.assert_array_equal(g2["b"], t2["b"])
    assert len(transfer._PACK_CACHE) == 2
    device_get_tree(t1)
    assert len(transfer._PACK_CACHE) == 2


def test_the_host_stager_is_pageable_on_the_cpu():
    stage, mode = make_host_stager("cpu")
    assert mode == "pageable"
    a = np.arange(6, dtype=np.int64).reshape(2, 3)
    out = stage(a)
    a[0, 0] = 99  # the staged copy is the stager's own
    assert out.dtype == torch.int64 and out.tolist() == [[0, 1, 2],
                                                         [3, 4, 5]]
    s = HostStager("cpu")
    b0, b1 = s.buffer(4, (3,), np.float32), s.buffer(4, (3,), np.float32)
    assert b0 is not b1 and s.buffer(4, (3,), np.float32) is b0


# --- Switch MoE --------------------------------------------------------


def _moe_params(rng, e=4, d=8, f=16):
    def r(*shape):
        return (rng.standard_normal(shape) * 0.3).astype(np.float32)

    return {"gate_w": r(d, e), "w1": r(e, d, f), "b1": r(e, f),
            "w2": r(e, f, d), "b2": r(e, d)}


def _jax_moe(x, p, **kw):
    return jax_switch_moe(jnp.asarray(x), **{k: jnp.asarray(v)
                                            for k, v in p.items()}, **kw)


def _moe_grads(fn, x, p):
    xt = _t(x).requires_grad_()
    pt = {k: _t(v).requires_grad_() for k, v in p.items()}
    out, aux = fn(xt, pt)
    w = torch.linspace(-1, 1, out.numel()).reshape(out.shape)
    ((out * w).sum() + 0.1 * aux).backward()
    return out, aux, xt.grad, {k: v.grad for k, v in pt.items()}


@pytest.mark.parametrize("case", ["ample", "drops", "masked", "groups"])
def test_switch_moe_matches_the_reference(case):
    """Values, aux and gradients: with ample capacity, with drops
    (capacity 1/8 of the share), with leading padding masked, and with
    several routing groups of 16 tokens."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((64, 8)).astype(np.float32)
    p = _moe_params(rng)
    kw = {"ample": dict(capacity_factor=4.0),
          "drops": dict(capacity_factor=0.5),
          "masked": dict(capacity_factor=0.5),
          "groups": dict(capacity_factor=1.0, group_size=16)}[case]
    mask = None
    if case == "masked":
        mask = np.concatenate([np.zeros(40, bool), np.ones(24, bool)])
    jmask = None if mask is None else jnp.asarray(mask)
    tmask = None if mask is None else torch.from_numpy(mask)

    def jloss(xx, pp):
        out, aux = jax_switch_moe(xx, **pp, token_mask=jmask, **kw)
        w = jnp.linspace(-1, 1, out.size).reshape(out.shape)
        return (out * w).sum() + 0.1 * aux, (out, aux)

    (_, (jout, jaux)), (jgx, jgp) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()})
    out, aux, gx, gp = _moe_grads(
        lambda xx, pp: switch_moe(xx, **pp, token_mask=tmask, **kw), x, p)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               atol=1e-5, rtol=1e-5)
    assert abs(float(aux.detach()) - float(jaux)) <= 1e-5
    np.testing.assert_allclose(gx.numpy(), np.asarray(jgx), atol=1e-4,
                               rtol=1e-4)
    for k in p:
        np.testing.assert_allclose(gp[k].numpy(), np.asarray(jgp[k]),
                                   atol=1e-4, rtol=1e-4, err_msg=k)
    if case == "drops":
        kept = (out.detach().abs().sum(1) > 0).sum()
        assert 0 < int(kept) < 64
    if case == "masked":
        assert float(out.detach()[:40].abs().sum()) == 0.0


def test_switch_moe_s_expert_axis_matches_the_reference_s():
    """ep = 2: each rank routes globally and computes its slice; the
    partials summed equal the reference's ``expert_axis`` form inside
    its shard_map, with drops."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((32, 8)).astype(np.float32)
    p = _moe_params(rng)
    mesh = jax_build_mesh(jax.devices()[:2], ep=2)
    ep_spec = P("ep")

    def run(xx, gw, w1, b1, w2, b2):
        return jax_switch_moe(xx, gw, w1, b1, w2, b2, capacity_factor=0.5,
                              expert_axis="ep")

    want, jaux = shard_map(
        run, mesh=mesh, in_specs=(P(), P(), ep_spec, ep_spec, ep_spec,
                                  ep_spec), out_specs=(P(), P()),
        check_vma=False)(jnp.asarray(x), *(jnp.asarray(p[k]) for k in (
            "gate_w", "w1", "b1", "w2", "b2")))

    def port(xx, pp):
        ws = [[pp[k][:2], pp[k][2:]] for k in ("w1", "b1", "w2", "b2")]
        return switch_moe(xx, pp["gate_w"], *ws, capacity_factor=0.5,
                          expert_axis=[CPU, CPU])

    out, aux, gx, gp = _moe_grads(port, x, p)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               atol=1e-5, rtol=1e-5)
    assert abs(float(aux.detach()) - float(jaux)) <= 1e-5
    out1, aux1, gx1, gp1 = _moe_grads(
        lambda xx, pp: switch_moe(xx, **pp, capacity_factor=0.5), x, p)
    np.testing.assert_allclose(out.detach().numpy(), out1.detach().numpy(),
                               atol=1e-6)
    np.testing.assert_allclose(gx.numpy(), gx1.numpy(), atol=1e-5)
    for k in p:
        np.testing.assert_allclose(gp[k].numpy(), gp1[k].numpy(), atol=1e-5)


# --- Pipeline ----------------------------------------------------------

D = 16


def _stacked(rng, s):
    return {"stage_w": (rng.standard_normal((s, D, D)) * 0.3).astype(
        np.float32),
            "stage_b": (rng.standard_normal((s, D)) * 0.1).astype(np.float32)}


def _jax_stage(params, x):
    return jnp.tanh(x @ params["stage_w"] + params["stage_b"])


def _stage(params, x):
    return torch.tanh(x @ params["stage_w"] + params["stage_b"])


@pytest.mark.parametrize("pp,micro,batch", [(4, 8, 32), (8, 8, 16)])
def test_pipelined_matches_the_reference_with_gradients(pp, micro, batch):
    rng = np.random.default_rng(3)
    params = _stacked(rng, pp)
    x = rng.standard_normal((batch, D)).astype(np.float32)
    jrun = jax_pipelined(_jax_stage, jax_build_mesh(jax.devices()[:pp], pp=pp),
                         n_microbatches=micro)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    want = np.asarray(jrun(jp, jnp.asarray(x)))
    jg = jax.grad(lambda p: (jrun(p, jnp.asarray(x)) ** 2).sum())(jp)
    run = pipelined(_stage, build_mesh([CPU] * pp, pp=pp),
                    n_microbatches=micro)
    tp = {k: _t(v).requires_grad_() for k, v in params.items()}
    out = run(tp, _t(x))
    np.testing.assert_allclose(out.detach().numpy(), want, atol=1e-5,
                               rtol=1e-5)
    (out ** 2).sum().backward()
    for k in params:
        np.testing.assert_allclose(tp[k].grad.numpy(), np.asarray(jg[k]),
                                   atol=1e-4, rtol=1e-4, err_msg=k)


def test_pipelined_refuses_an_indivisible_batch_and_over_stacked_params():
    rng = np.random.default_rng(4)
    run = pipelined(_stage, build_mesh([CPU] * 4, pp=4), n_microbatches=8)
    params = {k: _t(v) for k, v in _stacked(rng, 4).items()}
    with pytest.raises(ValueError, match="microbatches"):
        run(params, torch.zeros(30, D))
    over = {k: _t(v) for k, v in _stacked(rng, 8).items()}
    with pytest.raises(ValueError, match="stages"):
        run(over, torch.zeros(32, D))


def test_pipeline_apply_carries_trees_and_ticks():
    """A (activations, bool mask, count) microbatch tree: the stage sees
    each microbatch's tick, bool leaves come back bool, and every
    microbatch passed each stage once."""
    seen = []

    def stage(s, mb, t):
        x, m, n = mb
        seen.append((s, t))
        return x + s, m, n + 1

    xs = torch.arange(12.0).reshape(4, 3)
    ms = torch.tensor([[True], [False], [True], [True]])
    x, m, n = pipeline_apply(stage, [0, 1, 2], (xs, ms, torch.zeros(4)),
                             stage_takes_tick=True)
    assert torch.equal(x, xs + 3) and torch.equal(m, ms) and m.dtype == \
        torch.bool
    assert n.tolist() == [3.0] * 4
    assert sorted(seen) == sorted((s, mb + s) for s in range(3)
                                  for mb in range(4))
