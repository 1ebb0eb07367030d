"""In-process bus backend: deques and one condition variable.

The port's copy of ``MemoryBus`` from ``rafiki_tpu/bus/memory.py``
without the metrics and fault-injection hooks.
"""

from __future__ import annotations

import threading
import time
from collections import defaultdict, deque
from typing import Any, List, Optional

from .base import BaseBus


class MemoryBus(BaseBus):
    _shared: Optional["MemoryBus"] = None
    _shared_lock = threading.Lock()

    @classmethod
    def shared(cls) -> "MemoryBus":
        """Process-wide singleton, so every component that connects to
        ``memory://`` sees the same queues."""
        with cls._shared_lock:
            if cls._shared is None:
                cls._shared = cls()
            return cls._shared

    @classmethod
    def reset_shared(cls) -> None:
        """Drop the singleton (a platform's shutdown)."""
        with cls._shared_lock:
            cls._shared = None

    def __init__(self):
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._queues: dict = defaultdict(deque)
        self._kv: dict = {}

    # --- Queues ---

    def push(self, queue: str, value: Any) -> None:
        with self._cond:
            self._queues[queue].append(value)
            self._cond.notify_all()

    def push_many(self, items) -> None:
        with self._cond:
            for queue, value in items:
                self._queues[queue].append(value)
            self._cond.notify_all()

    def pop(self, queue: str, timeout: float = 0.0) -> Optional[Any]:
        deadline = time.monotonic() + timeout
        with self._cond:
            while not self._queues[queue]:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    self._reap(queue)
                    return None
                self._cond.wait(remaining)
            value = self._queues[queue].popleft()
            self._reap(queue)
            return value

    def pop_all(self, queue: str, max_items: int = 0,
                timeout: float = 0.0) -> List[Any]:
        first = self.pop(queue, timeout)
        if first is None:
            return []
        out = [first]
        with self._cond:
            q = self._queues[queue]
            while q and (max_items == 0 or len(out) < max_items):
                out.append(q.popleft())
            self._reap(queue)
        return out

    def _reap(self, queue: str) -> None:
        """Drop empty deques so uuid-keyed one-shot queues (per-query
        replies, per-RPC replies) do not accumulate. Caller holds the
        lock."""
        if not self._queues[queue]:
            del self._queues[queue]

    def delete_queue(self, queue: str) -> None:
        with self._lock:
            self._queues.pop(queue, None)

    def queue_len(self, queue: str) -> int:
        with self._lock:
            q = self._queues.get(queue)
            return len(q) if q else 0

    # --- Key-value ---

    def set(self, key: str, value: Any) -> None:
        with self._lock:
            self._kv[key] = value

    def get(self, key: str) -> Optional[Any]:
        with self._lock:
            return self._kv.get(key)

    def delete(self, key: str) -> None:
        with self._lock:
            self._kv.pop(key, None)

    def keys(self, prefix: str = "") -> List[str]:
        with self._lock:
            return sorted(k for k in self._kv if k.startswith(prefix))
