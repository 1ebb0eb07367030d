"""A node over several processes on ``torch.distributed`` (gloo on the
CPU): the counterpart of ``tests/test_multinode.py:214-252``.

- Two processes joined at one coordinator see 2 devices, 1 their own
  ("GLOBAL 2 LOCAL 1"), and report the backend gloo; four see 4.
- The chip allocator is sized to the global count; a group that holds
  another process's device raises ``NotAddressableError`` outside a
  step that every process runs and gives the local entry inside one.
- ``serve --coordinator/--num-processes/--process-id`` starts a node of
  two processes and stops it on SIGTERM.
- The dp batch rule (F9) over the global dp: a batch knob of 10 is 8
  rows a step over 4 processes, 10 over 2.
- An sp, ep, pp or tp axis across processes raises
  ``CrossProcessAxisError``, which names ROADMAP item 8 (e): nothing
  runs such a mesh in one process instead.

Every child gets a time limit and is killed past it; coordinators are
ports the kernel hands out or files in the test's own directory.
"""

import _torch_threads  # noqa: F401  (caps torch threads under xdist)

import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from _torch_dist import ROOT, child_env, free_port, run_node, spawn

FACTS = r"""
import sys
import torch
from rafiki_torch.parallel import ChipAllocator, ChipGroup, dist
from rafiki_torch.parallel.mesh import build_mesh
node = dist.initialize(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]))
print("GLOBAL", len(dist.devices()), "LOCAL", len(dist.local_devices()),
      "BACKEND", dist.backend(), "INDEX", dist.process_index())
print("ALLOCATOR", ChipAllocator(device="cpu").n_chips)
print("CURRENT", ChipGroup.current().n_chips)
group = ChipGroup(indices=tuple(range(dist.device_count())),
                  device_type="cpu")
try:
    group.device
    print("OUTSIDE ok")
except dist.NotAddressableError as e:
    print("OUTSIDE NotAddressableError")
with dist.every_process():
    print("INSIDE", group.device)
own = ChipGroup(indices=(dist.process_index(),), device_type="cpu")
print("OWN", own.device)
for axis in ("tp", "sp", "ep", "pp"):
    try:
        build_mesh(dist.devices(), **{axis: 2})
        print("MESH", axis, "built")
    except dist.CrossProcessAxisError as e:
        print("MESH", axis, "CrossProcessAxisError",
              "8 (e)" in str(e))
mesh = build_mesh(dist.devices())
print("DP", mesh.shape["dp"], "LOCAL_RANKS", mesh.local_ranks())
t = torch.tensor([float(dist.process_index() + 1)])
print("GATHER", dist.all_gather(t).flatten().tolist())
dist.shutdown()
print("DONE")
"""


def _facts(n, tmp_path):
    port = free_port()
    outs = spawn([[sys.executable, "-c", FACTS, f"127.0.0.1:{port}",
                   str(n), str(i)] for i in range(n)], child_env(),
                 limit=180)
    for rc, out in outs:
        assert rc == 0 and "DONE" in out, out[-3000:]
    return [out for _, out in outs]


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    return _facts(2, tmp_path_factory.mktemp("pair"))


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    return _facts(4, tmp_path_factory.mktemp("four"))


def test_a_cpu_pair_is_global_2_local_1(pair):
    for i, out in enumerate(pair):
        assert f"GLOBAL 2 LOCAL 1 BACKEND gloo INDEX {i}" in out, out


def test_four_processes_are_global_4_local_1(four):
    for i, out in enumerate(four):
        assert f"GLOBAL 4 LOCAL 1 BACKEND gloo INDEX {i}" in out, out
        assert "GATHER [1.0, 2.0, 3.0, 4.0]" in out, out


def test_the_allocator_is_sized_to_the_global_count(pair, four):
    for outs, n in ((pair, 2), (four, 4)):
        for out in outs:
            assert f"ALLOCATOR {n}" in out and f"CURRENT {n}" in out, out


def test_another_process_s_device_is_not_addressable_outside_a_step(pair):
    for out in pair:
        assert "OUTSIDE NotAddressableError" in out, out
        assert "INSIDE cpu" in out and "OWN cpu" in out, out


def test_a_mesh_over_the_pair_runs_its_own_rank(pair):
    for i, out in enumerate(pair):
        assert f"DP 2 LOCAL_RANKS [{i}]" in out, out
        assert "GATHER [1.0, 2.0]" in out, out


@pytest.mark.parametrize("axis", ["tp", "sp", "ep", "pp"])
def test_an_axis_across_processes_raises_the_named_error(axis, pair):
    for out in pair:
        assert f"MESH {axis} CrossProcessAxisError True" in out, out


def test_serve_starts_and_stops_a_node_of_two_processes(tmp_path):
    """``python -m rafiki_torch serve`` with the three flags: each
    process joins the group, reports it, serves its admin, and leaves on
    SIGTERM."""
    port = free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "rafiki_torch", "serve", "--workdir",
         str(tmp_path / f"w{i}"), "--port", "0", "--coordinator",
         f"127.0.0.1:{port}", "--num-processes", "2", "--process-id",
         str(i), "--log-level", "warning"],
        env=child_env(), cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for i in range(2)]
    outs = [[], []]
    readers = [threading.Thread(target=lambda p=p, o=o: o.extend(p.stdout),
                                daemon=True)
               for p, o in zip(procs, outs)]
    for t in readers:
        t.start()
    try:
        deadline = time.monotonic() + 150
        while not all(any("rafiki-tpu admin on" in x for x in o)
                      for o in outs):
            assert time.monotonic() < deadline and all(
                p.poll() is None for p in procs), outs
            time.sleep(0.1)
        for p in procs:
            p.send_signal(signal.SIGTERM)
        for p in procs:
            p.wait(timeout=60)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for t in readers:
            t.join(timeout=10)
    for i, (p, out) in enumerate(zip(procs, outs)):
        text = "".join(out)
        assert f"process group: process {i} of 2, GLOBAL 2 LOCAL 1, " \
               "backend gloo" in text, text
        assert "shutting down..." in text, text
        assert p.returncode == 0, text


@pytest.mark.parametrize("family,n,rows", [
    ("ff", 4, [8]), ("ff", 2, [10]), ("lm", 4, [8, 8]), ("lm", 2, [10, 10])])
def test_the_dp_batch_rule_over_the_global_dp(family, n, rows, tmp_path):
    """F9 over processes: the batch rounds down to a multiple of the
    global dp, as on one process's mesh of as many entries."""
    one, procs = run_node(family, n, 1, tmp_path, DIST_BATCH="10")
    for rec in [one] + procs:
        assert rec["__rows"].tolist() == rows
        assert int(rec["__dp"]) == n


def test_the_tagger_s_parallel_modes_across_processes_raise(tmp_path):
    """The transformer tagger's sp, ep, pp and MoE across two processes
    raise the named error when the mesh is built, before any step."""
    code = r"""
import sys
from rafiki_torch.models import TorchTransformerTagger
from rafiki_torch.parallel import ChipGroup, dist
dist.initialize(sys.argv[1], 2, int(sys.argv[2]))
ChipGroup(indices=(0, 1), device_type="cpu").bind_to_thread()
for knobs in ({"sequence_parallel": 2}, {"pipeline_parallel": 2},
              {"moe_experts": 2, "expert_parallel": 2},
              {"moe_experts": 2}, {"tensor_parallel": 1}):
    m = TorchTransformerTagger(device="cpu", n_layers=2, **knobs)
    try:
        print("MODE", sorted(knobs), "dp", m.mesh.shape["dp"])
    except dist.CrossProcessAxisError as e:
        print("MODE", sorted(knobs), "raises", "8 (e)" in str(e))
dist.shutdown()
print("DONE")
"""
    port = free_port()
    outs = spawn([[sys.executable, "-c", code, f"127.0.0.1:{port}", str(i)]
                  for i in range(2)], child_env(), limit=120)
    for rc, out in outs:
        assert rc == 0 and "DONE" in out, out[-3000:]
        assert "MODE ['sequence_parallel'] raises True" in out, out
        assert "MODE ['pipeline_parallel'] raises True" in out, out
        assert "MODE ['expert_parallel', 'moe_experts'] raises True" in out
        assert "MODE ['moe_experts'] raises True" in out, out
        assert "MODE ['tensor_parallel'] dp 2" in out, out


def test_the_image_zoo_s_tp_across_processes_raises(tmp_path):
    """``tensor_parallel`` 2 over two processes of one entry each would
    split a tp group across them: the named error; within a process (2
    processes of 2 entries) it builds dp 2 x tp 2."""
    code = r"""
import sys
from rafiki_torch.models import TorchViT
from rafiki_torch.parallel import ChipGroup, dist
local = int(sys.argv[3])
dist.initialize(sys.argv[1], 2, int(sys.argv[2]),
                local_devices=["cpu"] * local)
ChipGroup(indices=tuple(range(2 * local)),
          device_type="cpu").bind_to_thread()
m = TorchViT(device="cpu", tensor_parallel=2)
try:
    print("TP", dict(m.mesh.shape))
except dist.CrossProcessAxisError as e:
    print("TP raises", "8 (e)" in str(e))
dist.shutdown()
print("DONE")
"""
    got = []
    for local in (1, 2):
        port = free_port()
        outs = spawn([[sys.executable, "-c", code, f"127.0.0.1:{port}",
                       str(i), str(local)] for i in range(2)], child_env(),
                     limit=120)
        for rc, out in outs:
            assert rc == 0 and "DONE" in out, out[-3000:]
        got.append(outs)
    for _, out in got[0]:
        assert "TP raises True" in out, out
    for _, out in got[1]:
        assert "'dp': 2" in out and "'tp': 2" in out, out


@pytest.mark.parametrize("topology,backend", [
    ([[("cpu", 0, "cpu")], [("cpu", 0, "cpu")]], "gloo"),
    ([[("cuda", 0, "GPU-a")], [("cuda", 0, "GPU-a")]], "gloo"),
    ([[("cuda", 0, "GPU-a")], [("cuda", 0, "GPU-b")]], "nccl"),
    ([[("cuda", 0, "GPU-a"), ("cuda", 1, "GPU-b")],
      [("cuda", 0, "GPU-c"), ("cuda", 1, "GPU-d")]], "nccl"),
    ([[("cuda", 0, "GPU-a")], [("cpu", 0, "cpu")]], "gloo")])
def test_the_backend_is_chosen_from_the_topology(topology, backend,
                                                 monkeypatch):
    """NCCL where every rank has a card of its own, gloo where the ranks
    are on the CPU or share a card (NCCL refuses two ranks on one
    device); one host."""
    from rafiki_torch.parallel import dist

    monkeypatch.setattr(dist.tdist, "is_nccl_available", lambda: True)
    procs = [{"host": "h", "devices": d} for d in topology]
    assert dist.choose_backend(procs) == backend


def test_nothing_falls_back_to_one_process():
    """Without a node, a mesh never spans processes and the collectives'
    backend is None: a family runs its own mesh, not a stand-in."""
    from rafiki_torch.parallel import dist
    from rafiki_torch.parallel.mesh import build_mesh

    assert not dist.is_initialized() and dist.backend() is None
    assert not build_mesh(["cpu", "cpu"]).spans_processes
    assert np.array_equal(build_mesh(["cpu"] * 4).local_ranks(),
                          [0, 1, 2, 3])
