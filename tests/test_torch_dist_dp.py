"""Data parallelism across processes, against the one-process mesh.

Each family trains two steps across 2 or 4 CPU processes (gloo), one
rank a process, or 2 processes of 2 ranks (the local partials summed
first), and on one process's mesh of the same number of entries, which
``tests/test_torch_dp_*.py`` already hold against the reference: the
same seeded parameters and rows. Over 2 processes the losses and every
parameter (and DenseNet's running statistics, normalised by the whole
batch's moments) are bit for bit the one-process mesh's: a sum of two
is the same in either order. Over 4 ranks the parameters' gradients
add in the collective's order, not autograd's: the losses within 1e-6
of each other (relative) and every parameter within 1e-6 (measured
1.2e-7 at most). Every process ends with the same parameters.
"""

import _torch_threads  # noqa: F401  (caps torch threads under xdist)

import numpy as np
import pytest

from _torch_dist import run_node


def _check(one, procs, exact):
    meta = ("__losses", "__rows", "__dp")
    for rec in procs:
        assert int(rec["__dp"]) == int(one["__dp"])
        np.testing.assert_array_equal(rec["__rows"], one["__rows"])
        assert len(one["__losses"]) >= 1
        keys = [k for k in one if k not in meta]
        assert keys and sorted(keys) == sorted(k for k in rec
                                               if k not in meta)
        if exact:
            np.testing.assert_array_equal(rec["__losses"], one["__losses"])
            for k in keys:
                np.testing.assert_array_equal(rec[k], one[k], err_msg=k)
        else:
            np.testing.assert_allclose(rec["__losses"], one["__losses"],
                                       rtol=1e-6, atol=0)
            for k in keys:
                np.testing.assert_allclose(rec[k], one[k], rtol=0,
                                           atol=1e-6, err_msg=k)
    for rec in procs[1:]:
        for k in rec:
            np.testing.assert_array_equal(rec[k], procs[0][k], err_msg=k)


@pytest.mark.parametrize("family,n,local", [
    ("lm", 2, 1), ("lm", 4, 1), ("ff", 2, 1), ("vit", 2, 1),
    ("vit", 4, 1), ("densenet", 2, 1), ("densenet", 4, 1),
    ("densenet", 2, 2)])
def test_dp_across_processes_matches_one_process(family, n, local,
                                                 tmp_path):
    one, procs = run_node(family, n, local, tmp_path)
    assert int(one["__dp"]) == n * local
    _check(one, procs, exact=(n * local == 2))
