"""Caps torch's CPU threads in the port's tests under pytest-xdist.

Each xdist worker is a process, and torch gives each one an intra-op
pool as wide as the machine. With several workers the pools together
ask for several times the cores: the spinning OpenMP threads then slow
a train test of ``tests/test_torch_lm_train.py`` from seconds to
minutes. Every ``tests/test_torch_*.py`` imports this module, which
gives each worker its share of the cores (``os.cpu_count()`` over
``PYTEST_XDIST_WORKER_COUNT``, at least one). A run without xdist keeps
torch's default.
"""

import os

import torch


def cap_threads() -> int:
    """Set this worker's share of the cores as torch's intra-op (and,
    while it can still be set, inter-op) thread count; returns it, or 0
    when the process is not an xdist worker."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "0") or 0)
    if workers <= 1:
        return 0
    n = max(1, (os.cpu_count() or 1) // workers)
    torch.set_num_threads(n)
    try:
        torch.set_num_interop_threads(n)
    except RuntimeError:
        pass  # set once per process, before any inter-op work
    return n


cap_threads()
