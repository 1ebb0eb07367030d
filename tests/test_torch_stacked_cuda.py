"""Ensemble serving on the card: predict runners captured as CUDA graphs
against the same forward run eagerly, a restack that the graphs read
with no recapture, and ``int8_mm`` at the shapes it pads.

These tests need a CUDA device and skip without one. On a machine with a
card and without JAX, run them without the JAX test configuration:

    python -m pytest --noconftest -m cuda tests/test_torch_stacked_cuda.py

A runner's graph replays the kernels its eager forward launches, on the
same buffers, so its result must be the same bits. Two threads building
runners at once must both succeed: a capture's start synchronises the
device, and side streams come from one shared pool, so captures and
warm-ups take one lock (``torchenv.side_stream``, ``graph_capture``). A CUDA
graph destroyed inside a capture breaks it, so the collector is off for
a capture; a capture that fails leaves its memory pool marked as
recording, so the next runner takes a fresh pool. cuBLASLt's int8
product is exact (int32 sums of int8 products, far from overflow), so it
must equal the int64 product on the CPU.
"""

import _torch_threads  # noqa: F401  (caps torch threads under xdist)
import gc
import threading

import numpy as np
import pytest
import torch

from rafiki_torch.model.bridge import dense_to_jax
from rafiki_torch.model.torch_model import (PredictRunners, int8_mm,
                                           stack_members)
from rafiki_torch.models import TorchDenseNet, TorchEnas, TorchFeedForward

pytestmark = pytest.mark.cuda

FF_SHAPE = (28, 28, 1)
CONV_SHAPE = (32, 32, 3)
ROWS = (1, 17, 512)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _member(cls, shape, seed, **knobs):
    net = cls(device="cpu", seed=seed, **knobs).create_module(10, shape)
    p = dense_to_jax(net.state_dict())
    p["_meta/n_classes"] = np.asarray(10)
    p["_meta/image_shape"] = np.asarray(shape)
    m = cls(device="cuda", **knobs)
    m.load_parameters(p)
    return m


def _ff(seed, units=64):
    return _member(TorchFeedForward, FF_SHAPE, seed, hidden_layer_count=2,
                   hidden_layer_units=units)


def _densenet(seed):
    return _member(TorchDenseNet, CONV_SHAPE, seed, arch="densenet_tiny",
                   growth_rate=8)


class _TinyEnas(TorchEnas):
    n_blocks = 2
    full_cells, full_channels = 3, 8
    search_cells, search_channels = 3, 8


def _enas(seed):
    arch = [int(v) for v in np.random.default_rng(seed).integers(
        0, 2, 16)]
    return _member(_TinyEnas, CONV_SHAPE, seed, arch=arch,
                   share_params=True)


def _images(shape, n, seed=0):
    return (np.random.default_rng(seed).random((n, *shape)) * 255).astype(
        np.uint8)


def _staged(owner, q):
    bucket = owner.predict_bucket(q.shape[0], q.dtype)
    buf = np.zeros((bucket, *q.shape[1:]), q.dtype)
    buf[:q.shape[0]] = q
    return buf


@pytest.mark.parametrize("make", [_ff, _densenet])
@pytest.mark.parametrize("quant", [None, "int8"])
def test_single_model_graphs_equal_eager(card, make, quant):
    m = make(0)
    m.enable_serving_quant(quant)
    shape = tuple(m._meta["image_shape"])
    for n in ROWS:
        buf = _staged(m, _images(shape, n))
        dev, _ = m._dispatch_bucket(buf, n)
        runner = m._runners.runners[(buf.shape[0], True, m._quant_mode)]
        assert runner.graph is not None
        with torch.no_grad():
            eager = runner.fn(torch.from_numpy(buf).to(card))
        assert torch.equal(dev, eager), n
    assert m.captures == len(ROWS)


@pytest.mark.parametrize("make", [_ff, _densenet, _enas])
@pytest.mark.parametrize("quant", [None, "int8"])
def test_stacked_graphs_equal_eager(card, make, quant):
    ms = [make(s) for s in range(3)]
    for m in ms:
        m.enable_serving_quant(quant)
    st = stack_members(ms)
    shape = tuple(ms[0]._meta["image_shape"])
    for n in ROWS:
        buf = _staged(st, _images(shape, n, seed=n))
        dev, _ = st.staged_submit(buf, n)
        runner = st._runners.runners[(buf.shape[0], True, st._quant)]
        with torch.no_grad():
            eager = runner.fn(torch.from_numpy(buf).to(card))
        assert torch.equal(dev, eager), n
        assert dev.shape == (3, buf.shape[0], 10)
    assert st.captures == len(ROWS)


@pytest.mark.parametrize("quant", [None, "int8"])
def test_a_restack_is_read_by_the_graphs_without_a_recapture(card, quant):
    ms = [_densenet(s) for s in range(3)]
    incoming = _densenet(9)
    for m in ms + [incoming]:
        m.enable_serving_quant(quant)
    st = stack_members(ms)
    q = _images(CONV_SHAPE, 17)
    buf = _staged(st, q)
    before = st.staged_submit(buf, 17)[0].cpu()
    captures = st.captures
    st.update_member(1, incoming)
    after = st.staged_submit(buf, 17)[0].cpu()
    assert st.captures == captures
    assert torch.equal(after[0], before[0]) and torch.equal(after[2],
                                                            before[2])
    assert not torch.equal(after[1], before[1])
    # A group built afresh on the new members gives the same bits.
    fresh = stack_members([ms[0], incoming, ms[2]])
    assert torch.equal(fresh.staged_submit(buf, 17)[0].cpu(), after)


@pytest.mark.parametrize("m", [1, 16, 17, 32, 33, 512])
@pytest.mark.parametrize("k,n", [(784, 128), (128, 10), (100, 30),
                                 (3072, 24)])
def test_int8_mm_is_exact_at_the_padded_shapes(card, m, k, n):
    g = torch.Generator().manual_seed(m * 7 + k + n)
    x = torch.randint(-127, 128, (m, k), dtype=torch.int8, generator=g)
    w = torch.randint(-127, 128, (k, n), dtype=torch.int8, generator=g)
    got = int8_mm(x.to(card), w.to(card))
    assert got.dtype == torch.int32 and got.shape == (m, n)
    assert torch.equal(got.cpu().long(), x.long() @ w.long())


def test_two_threads_build_runners_at_once(card):
    models = [_densenet(s) for s in range(2)]
    q = _images(CONV_SHAPE, 33)
    want = [[m.predict_proba(q[:n]) for n in (1, 3, 9, 17, 33)]
            for m in (_densenet(0), _densenet(1))]
    got, errors = [[], []], []

    def serve(i):
        try:
            for n in (1, 3, 9, 17, 33):
                got[i].append(models[i].predict_proba(q[:n]))
        except Exception as e:  # reported by the assertion below
            errors.append(e)

    threads = [threading.Thread(target=serve, args=(i,)) for i in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    for i in (0, 1):
        assert models[i].captures == 5
        for a, b in zip(got[i], want[i]):
            np.testing.assert_array_equal(a, b)


def test_a_cycle_holding_graphs_is_not_collected_inside_a_capture(card):
    m = _ff(0)
    m.predict_proba(_images(FF_SHAPE, 1))
    assert m.captures >= 1
    held = [m]
    del m

    def fn(x):
        # Inside the capture, the last reference to the model (and its
        # captured graphs) goes into a garbage cycle, and enough objects
        # are made for the collector to run if it may.
        if torch.cuda.is_current_stream_capturing() and held:
            cycle = {"model": held.pop()}
            cycle["self"] = cycle
            del cycle
            threshold = gc.get_threshold()
            gc.set_threshold(1)
            try:
                [[] for _ in range(1000)]
            finally:
                gc.set_threshold(*threshold)
        return x * 2

    runners = PredictRunners(card)
    x = torch.arange(4.0, device=card)
    out = runners.run("k", x, lambda: fn)
    assert runners.captures == 1 and torch.equal(out, x * 2)
    gc.collect()
    assert torch.equal(runners.run("k", x + 1, lambda: fn), (x + 1) * 2)


def test_a_failed_capture_leaves_later_captures_working(card):
    runners = PredictRunners(card)
    x = torch.arange(4.0, device=card)
    runners.run("a", x, lambda: lambda v: v + 1)

    def broken(v):
        if torch.cuda.is_current_stream_capturing():
            torch.cuda.synchronize()  # not permitted: breaks the capture
        return v * 3

    with pytest.raises(Exception):
        runners.run("b", x, lambda: broken)
    for key, fn, want in (("b", lambda v: v * 3, x * 3),
                          ("c", lambda v: v - 1, x - 1),
                          ("a", None, x + 1)):
        assert torch.equal(runners.run(key, x, lambda: fn), want)
    assert runners.captures == 3
