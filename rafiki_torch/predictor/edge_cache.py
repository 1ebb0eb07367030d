"""Content addressing of queries: the port's copy of ``query_key`` from
``rafiki_tpu/predictor/edge_cache.py``. The edge cache itself is not
ported; the generative engine's prefix cache keys on this digest."""

from __future__ import annotations

import hashlib
import json
from typing import Any


def query_key(encoded_query: Any) -> str:
    """Content address of one wire-encoded query frame. The frame is
    already JSON-safe, so a sorted-key dump is canonical: the same
    values yield the same key no matter which client framed them."""
    blob = json.dumps(encoded_query, sort_keys=True,
                      separators=(",", ":"), default=str)
    return hashlib.blake2b(blob.encode("utf-8"),
                           digest_size=16).hexdigest()
