"""The transformer tagger's pp × ep mode: logits against the
reference's tagger on the same weights, on a mesh of 4 entries, as
``test_torch_tagger_modes.py`` (the bf16 logits within 2^-5). Each
rank's microbatch of one sentence routes on its own, 5 slots an expert
for its 16 tokens, as the reference's shard_map routes it.
"""

import _torch_threads  # noqa: F401  (caps torch threads under xdist)

from test_torch_tagger_modes import logits_match


def test_a_mode_s_logits_match_the_reference_s():
    logits_match("pp_ep")
