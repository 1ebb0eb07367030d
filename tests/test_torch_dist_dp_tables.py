"""Data parallelism across processes for the tables, the BiLSTM and the
transformer tagger's dp mode, against the one-process mesh; the
tolerances are ``tests/test_torch_dist_dp.py``'s (bit for bit over 2
ranks, 1e-6 over 4)."""

import _torch_threads  # noqa: F401  (caps torch threads under xdist)

import pytest

from _torch_dist import run_node
from test_torch_dist_dp import _check


@pytest.mark.parametrize("family,n,local", [
    ("tables", 2, 1), ("tables", 4, 1), ("bilstm", 2, 1), ("bilstm", 4, 1),
    ("tagger", 2, 1), ("tagger", 4, 1), ("tagger", 2, 2)])
def test_dp_across_processes_matches_one_process(family, n, local,
                                                 tmp_path):
    one, procs = run_node(family, n, local, tmp_path)
    assert int(one["__dp"]) == n * local
    _check(one, procs, exact=(n * local == 2))
