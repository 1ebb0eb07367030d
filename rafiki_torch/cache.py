"""Token-frame queues: the in-process counterpart of the two frame
methods of the reference's ``Cache`` (``rafiki_tpu/cache.py``,
``send_token_frame`` and ``pop_token_frames``).

The port has no bus yet, so a generate request's reply queue is a
deque per query id in this process. The frames are the reference's:
``{"seq": k, "tok": [t], "done": ...}``, the last one with ``finish``
and ``n_tokens`` (and ``error`` when it failed), each stamped with the
``worker_id`` that produced it.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Deque, Dict, List


class TokenFrames:
    """One FIFO of token frames per query id, pushed by a worker's
    decode loop and popped by the HTTP handler that streams them."""

    def __init__(self):
        self._cv = threading.Condition()
        self._queues: Dict[str, Deque[Dict[str, Any]]] = {}

    def send_token_frame(self, query_id: str, worker_id: str,
                         frame: Dict[str, Any]) -> None:
        """Push one token frame (worker side)."""
        with self._cv:
            self._queues.setdefault(query_id, deque()).append(
                dict(frame, worker_id=worker_id))
            self._cv.notify_all()

    def pop_token_frames(self, query_id: str,
                         timeout: float = 1.0) -> List[Dict[str, Any]]:
        """Every frame that has arrived for ``query_id``, waiting up to
        ``timeout`` seconds for the first; an empty list when none
        came."""
        deadline = time.monotonic() + timeout
        with self._cv:
            while not self._queues.get(query_id):
                left = deadline - time.monotonic()
                if left <= 0:
                    return []
                self._cv.wait(left)
            return list(self._queues.pop(query_id))
