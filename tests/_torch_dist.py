"""Shared set-up of the cross-process tests (``tests/test_torch_dist*.py``).

``spawn`` starts child processes of the port alone and waits for them
under a time limit, killing any that outlive it. ``run_node`` trains a
family across ``n`` processes of ``local`` CPU entries each (a node
joined through a ``file://`` address in the test's own directory, so
parallel test workers never share a port) and on the one-process mesh of
the same ``n * local`` entries, all at once, and returns each run's
record (``tests/_torch_dist_child.py``). ``free_port`` is a port the
kernel hands out for a child's coordinator.
"""

import os
import socket
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CHILD = os.path.join(HERE, "_torch_dist_child.py")
LIMIT_S = 240.0


def child_env(**extra):
    env = dict(os.environ)
    env.update(PYTHONPATH=ROOT, RAFIKI_TPU_PLATFORM="cpu",
               OMP_NUM_THREADS="1", **extra)
    env.pop("XLA_FLAGS", None)
    return env


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(cmds, env, limit=LIMIT_S):
    """Run ``cmds`` at once; ``[(returncode, output)]`` in order. A
    child still running at the limit is killed (and fails)."""
    procs = [subprocess.Popen(c, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT) for c in cmds]
    deadline = time.monotonic() + limit
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=max(1.0,
                                               deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
        outs.append((p.returncode, out.decode(errors="replace")))
    for p in procs:
        if p.poll() is None:
            p.kill()
    return outs


def run_node(family, n, local, tmp, **env_extra):
    """``(one-process record, [each process's record])`` of ``family``
    trained across ``n`` processes of ``local`` entries, and on one
    process's mesh of ``n * local`` entries."""
    tmp = str(tmp)
    init = "file://" + os.path.join(tmp, "init")
    cmds = [[sys.executable, CHILD, family, os.path.join(tmp, "data_one"),
             os.path.join(tmp, "one.npz"), "-", "0", "0", str(n * local)]]
    cmds += [[sys.executable, CHILD, family, os.path.join(tmp, f"data_{r}"),
              os.path.join(tmp, f"p{r}.npz"), init, str(n), str(r),
              str(local)] for r in range(n)]
    outs = spawn(cmds, child_env(**env_extra))
    for rc, out in outs:
        assert rc == 0 and "DIST CHILD OK" in out, out[-3000:]
    one = dict(np.load(os.path.join(tmp, "one.npz")))
    procs = [dict(np.load(os.path.join(tmp, f"p{r}.npz")))
             for r in range(n)]
    return one, procs
