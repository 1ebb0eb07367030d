"""The ``ParamStore`` write-behind, the port's against the reference's.

The reference's cases (``tests/test_store.py:155-263``) run on both
stores side by side, with the same gated flush (``_flush_to_disk``
held until the test opens the gate): jax arrays into the reference's
store, tensors into the port's. Each case's observations (rows, files,
listings, the retrieved values) must be equal between the two. Then:
files byte for byte equal between the packages and between write-behind
on and off; a dump that an in-place optimizer step after it leaves
unchanged (it fails on a dump that aliases the module's tensors); and a
``TorchFeedForward`` warm start from the in-memory tree equal to one
from the file.
"""

import _torch_threads  # noqa: F401  (caps torch threads under xdist)

import os
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rafiki_torch.constants import ParamsType
from rafiki_torch.datasets import make_synthetic_image_dataset
from rafiki_torch.model.logger import logger as torch_logger
from rafiki_torch.models import TorchFeedForward
from rafiki_torch.store.params import ParamStore
from rafiki_tpu.store.params import ParamStore as JaxParamStore

PACKAGES = ("ref", "port")


def _store(which, root):
    cls = JaxParamStore if which == "ref" else ParamStore
    return cls(str(root / which))


def _dev(which, value):
    """A device leaf of ``value``: a jax array, or a tensor."""
    a = np.asarray(value, np.float32)
    return jnp.asarray(a) if which == "ref" else torch.from_numpy(a.copy())


def _rows(store, pid):
    with store._lock:
        return store._db.execute("SELECT COUNT(*) FROM params WHERE id = ?",
                                 (pid,)).fetchone()[0]


def _gate(store, in_flush=None):
    """Hold ``store``'s flushes until the returned event is set."""
    orig = store._flush_to_disk
    gate = threading.Event()

    def slow_flush(pid, tree):
        if in_flush is not None:
            in_flush.set()
        gate.wait(10)
        orig(pid, tree)

    store._flush_to_disk = slow_flush
    return gate


def _row_lands_after_file(which, root):
    store = _store(which, root)
    gate = _gate(store)
    pid = store.save({"w": _dev(which, np.full((3,), 2.0))},
                     session_id="wb", worker_id="w0", score=0.7)
    try:
        window = (_rows(store, pid), os.path.exists(store._path(pid)),
                  float(np.asarray(store.retrieve(
                      ParamsType.GLOBAL_BEST, session_id="wb")["w"])[0]),
                  store.session_params_ids("wb") == [pid],
                  store.exists(pid), store.get_in_memory(pid) is not None)
    finally:
        gate.set()
    store.flush()
    after = (os.path.exists(store._path(pid)), _rows(store, pid),
             store.session_params_ids("wb") == [pid],
             store.get_in_memory(pid) is None,
             np.asarray(store.load(pid)["w"]).tolist())
    store.close()
    return window, after


def _ranks_pending_against_indexed(which, root):
    store = _store(which, root)
    store.save({"w": np.asarray([1.0], np.float32)}, session_id="s",
               worker_id="w0", score=0.9)
    gate = _gate(store)
    store.save({"w": _dev(which, [2.0])}, session_id="s", worker_id="w0",
               score=0.3)
    try:
        got = [float(np.asarray(store.retrieve(
            t, session_id="s", worker_id="w0")["w"]).reshape(-1)[0])
            for t in (ParamsType.GLOBAL_RECENT, ParamsType.GLOBAL_BEST,
                      ParamsType.LOCAL_RECENT, ParamsType.LOCAL_BEST)]
        other = store.retrieve(ParamsType.LOCAL_RECENT, session_id="s",
                               worker_id="w1")
    finally:
        gate.set()
    store.flush()
    store.close()
    return got, other


def _delete_races_writer(which, root):
    store = _store(which, root)
    in_flush = threading.Event()
    gate = _gate(store, in_flush)
    pid = store.save({"w": _dev(which, np.zeros(2))}, session_id="race")
    assert in_flush.wait(10), "writer never started the flush"
    store.delete(pid)  # mid-flush
    gate.set()
    # The raced save is settled once a later save (FIFO) is flushed.
    store.save({"w": _dev(which, np.zeros(2))}, session_id="race2")
    store.flush()
    deadline = time.monotonic() + 10
    while store._pending and time.monotonic() < deadline:
        time.sleep(0.05)
    out = (os.path.exists(store._path(pid)), _rows(store, pid),
           store.exists(pid))
    store.close()
    return out


def _load_waits(which, root):
    store = _store(which, root)
    gate = _gate(store)
    pid = store.save({"w": _dev(which, [5.0, 6.0])}, session_id="s")
    threading.Timer(0.3, gate.set).start()
    t0 = time.monotonic()
    got = np.asarray(store.load(pid)["w"]).tolist()
    waited = time.monotonic() - t0 >= 0.25
    store.close()
    return got, waited


def _close_drains(which, root):
    store = _store(which, root)
    gate = _gate(store)
    pids = [store.save({"w": _dev(which, [float(i)])}, session_id="c")
            for i in range(3)]
    threading.Timer(0.2, gate.set).start()
    store.close()
    again = _store(which, root)
    out = [np.asarray(again.load(p)["w"]).tolist() for p in pids]
    listed = again.session_params_ids("c") == pids
    again.close()
    return out, listed


def _switch_off_is_synchronous(which, root, monkeypatch):
    monkeypatch.setenv("RAFIKI_TPU_PARAMS_WRITE_BEHIND", "0")
    store = _store(which, root)
    pid = store.save({"w": _dev(which, [3.0])}, session_id="s")
    out = (os.path.exists(store._path(pid)), _rows(store, pid),
           store._writer is None, store.get_in_memory(pid) is None)
    store.close()
    return out


CASES = {
    "row_lands_after_file": _row_lands_after_file,
    "ranks_pending_against_indexed": _ranks_pending_against_indexed,
    "delete_races_writer": _delete_races_writer,
    "load_waits_for_flush": _load_waits,
    "close_drains": _close_drains,
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_the_write_behind_cases_match_the_reference(case, tmp_path):
    got = {which: CASES[case](which, tmp_path) for which in PACKAGES}
    assert got["port"] == got["ref"], got


def test_the_reference_cases_hold(tmp_path):
    """The reference's own expectations, on the port's store."""
    window, after = _row_lands_after_file("port", tmp_path / "a")
    assert window == (0, False, 2.0, True, True, True)
    assert after == (True, 1, True, True, [2.0, 2.0, 2.0])
    got, other = _ranks_pending_against_indexed("port", tmp_path / "b")
    assert got == [2.0, 1.0, 2.0, 1.0] and other is None
    assert _delete_races_writer("port", tmp_path / "c") == (False, 0, False)
    assert _load_waits("port", tmp_path / "d") == ([5.0, 6.0], True)
    assert _close_drains("port", tmp_path / "e") == ([[0.0], [1.0], [2.0]],
                                                     True)


@pytest.mark.parametrize("which", PACKAGES)
def test_the_switch_off_makes_saves_synchronous(which, tmp_path,
                                                monkeypatch):
    assert _switch_off_is_synchronous(which, tmp_path, monkeypatch) == \
        (True, 1, True, True)


def _tree(which):
    rng = np.random.default_rng(0)
    flat = {"params/Dense_0/kernel": rng.standard_normal((6, 5)),
            "params/Dense_0/bias": rng.standard_normal(5),
            "batch_stats/BatchNorm_0/mean": rng.standard_normal(5)}
    out = {k: _dev(which, v) for k, v in flat.items()}
    out["_meta/n_classes"] = np.asarray(3)
    out["_meta/image_shape"] = np.asarray([8, 8, 3])
    return out


@pytest.mark.parametrize("write_behind", ["1", "0"])
def test_files_are_byte_equal_across_packages(write_behind, tmp_path,
                                              monkeypatch):
    """Jax arrays into the reference's store and tensors into the
    port's give byte-equal files, write-behind on and off, and equal to
    the port's synchronous file of the same host arrays."""
    monkeypatch.setenv("RAFIKI_TPU_PARAMS_WRITE_BEHIND", write_behind)
    blobs = []
    for which in PACKAGES:
        store = _store(which, tmp_path)
        pid = store.save(_tree(which), session_id="s")
        store.flush()
        with open(store._path(pid), "rb") as f:
            blobs.append(f.read())
        store.close()
    host = ParamStore(str(tmp_path / "host"))
    pid = host.save({k: np.asarray(v) for k, v in _tree("port").items()},
                    session_id="s")
    with open(host._path(pid), "rb") as f:
        blobs.append(f.read())
    host.close()
    assert blobs[0] == blobs[1] == blobs[2]


FF_KNOBS = {"hidden_layer_count": 1, "hidden_layer_units": 16,
            "learning_rate": 1e-2, "batch_size": 8, "max_epochs": 1}


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    root = tmp_path_factory.mktemp("wb_images")
    return make_synthetic_image_dataset(str(root), n_train=32, n_val=8,
                                        image_shape=(6, 6, 1), n_classes=3,
                                        seed=0)


def _trained(images):
    torch.manual_seed(0)
    m = TorchFeedForward(device="cpu", **FF_KNOBS)
    prior = torch_logger.current_sink()
    torch_logger.set_sink(lambda rec: None)
    try:
        m.train(images[0])
    finally:
        torch_logger.set_sink(prior)
    return m


def test_a_dump_is_a_snapshot(images):
    """An in-place optimizer step after ``dump_parameters`` (and the
    module's ``destroy``) leaves the dumped tree as it was."""
    m = _trained(images)
    net = m._net
    dumped = m.dump_parameters()
    before = {k: np.array(np.asarray(v), copy=True)
              for k, v in dumped.items()}
    assert all(isinstance(v, torch.Tensor) for k, v in dumped.items()
               if not k.startswith("_meta/"))
    opt = torch.optim.SGD(net.parameters(), lr=1.0)
    for p in net.parameters():
        p.grad = torch.ones_like(p)
    opt.step()
    with torch.no_grad():
        for b in net.buffers():
            b.add_(1.0)
    m.destroy()
    for k, v in dumped.items():
        np.testing.assert_array_equal(np.asarray(v), before[k], err_msg=k)


def test_a_warm_start_from_memory_equals_one_from_the_file(images,
                                                           tmp_path):
    """The next trial's warm start from a pending save's in-memory tree
    (``retrieve`` inside the window) equals the one from its file, and
    copies: the new net shares no storage with the pending tree."""
    m = _trained(images)
    store = ParamStore(str(tmp_path / "p"))
    gate = _gate(store)
    store.save(m.dump_parameters(), session_id="s", worker_id="w0",
               score=0.5)
    try:
        mem = store.retrieve(ParamsType.GLOBAL_RECENT, session_id="s")
        assert any(isinstance(v, torch.Tensor) for v in mem.values())
        warm = TorchFeedForward(device="cpu", **FF_KNOBS)
        net_mem = warm._new_net(3, (6, 6, 1))
        warm._merge_shared(net_mem, mem)
        ptrs = {v.data_ptr() for v in mem.values()
                if isinstance(v, torch.Tensor)}
        assert not ptrs & {t.data_ptr()
                           for t in net_mem.state_dict().values()}
    finally:
        gate.set()
    store.flush()
    from_file = store.retrieve(ParamsType.GLOBAL_RECENT, session_id="s")
    assert all(isinstance(v, np.ndarray) for v in from_file.values())
    net_file = warm._new_net(3, (6, 6, 1))
    warm._merge_shared(net_file, from_file)
    a, b = net_mem.state_dict(), net_file.state_dict()
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    store.close()
