"""A train epoch of two steps of the transformer tagger's MoE modes
against the reference's, and a parameter file of each port mode loaded
into the reference.

As ``test_torch_tagger_train_modes.py`` (float32, 4 entries, 16
sentences at batch 8, the same tolerances), for ``ep_moe`` (4 experts
over ep 2, routed over the whole batch) and ``pp_ep`` (each rank's
microbatch of one sentence routed on its own, 5 slots an expert for 16
tokens, so tokens drop). Both add 0.01 times the load-balance loss, as
the reference does.
"""

import _torch_threads  # noqa: F401  (caps torch threads under xdist)

import pytest

from test_torch_tagger_train_modes import corpus, one_step_matches  # noqa: F401


@pytest.mark.parametrize("mode", ["ep_moe", "pp_ep"])
def test_one_step_and_the_file_match_the_reference(mode, corpus,  # noqa: F811
                                                   monkeypatch):
    one_step_matches(mode, corpus, monkeypatch)
