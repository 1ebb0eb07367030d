"""A train epoch of two steps of the transformer tagger's pipeline
modes against the reference's, and a parameter file of each port mode
loaded into the reference.

As ``test_torch_tagger_train_modes.py`` (float32, 4 entries, 16
sentences at batch 8, the same tolerances), for ``pp`` (2 stages, auto
microbatches) and ``pp_sp`` (the ring inside the stages); the MoE modes
are in ``test_torch_tagger_train_moe_modes.py``.
"""

import _torch_threads  # noqa: F401  (caps torch threads under xdist)

import pytest

from test_torch_tagger_train_modes import corpus, one_step_matches  # noqa: F401


@pytest.mark.parametrize("mode", ["pp", "pp_sp"])
def test_one_step_and_the_file_match_the_reference(mode, corpus,  # noqa: F811
                                                   monkeypatch):
    one_step_matches(mode, corpus, monkeypatch)
