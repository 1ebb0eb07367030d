"""The bus interface every backend implements.

The port's copy of ``BaseBus`` from ``rafiki_tpu/bus/base.py`` without
the metrics hooks and the inter-node relay. Values are JSON-serialisable
Python objects (dict, list, str, number, None); numpy payloads ride
base64-framed (``rafiki_torch.cache``).
"""

from __future__ import annotations

import abc
from typing import Any, List, Optional, Sequence, Tuple


class BaseBus(abc.ABC):
    # --- Queues ---

    @abc.abstractmethod
    def push(self, queue: str, value: Any) -> None:
        """Append ``value`` to ``queue`` (FIFO)."""

    def push_many(self, items: Sequence[Tuple[str, Any]]) -> None:
        """Append each ``(queue, value)`` pair, in order. A backend may
        do it in one lock hold or one round trip: the serving scatter
        pushes one frame per worker."""
        for queue, value in items:
            self.push(queue, value)

    @abc.abstractmethod
    def pop(self, queue: str, timeout: float = 0.0) -> Optional[Any]:
        """Pop the oldest item; block up to ``timeout`` seconds; None if
        empty."""

    @abc.abstractmethod
    def pop_all(self, queue: str, max_items: int = 0,
                timeout: float = 0.0) -> List[Any]:
        """Drain up to ``max_items`` (0 = unlimited) items; blocks up to
        ``timeout`` for the FIRST item, then drains whatever is queued
        (the batched-inference pattern: wait for one query, take the
        burst)."""

    @abc.abstractmethod
    def queue_len(self, queue: str) -> int:
        pass

    @abc.abstractmethod
    def delete_queue(self, queue: str) -> None:
        """Drop a queue and anything still in it (one-shot reply queues
        whose consumer timed out are reaped through this)."""

    # --- Key-value registry ---

    @abc.abstractmethod
    def set(self, key: str, value: Any) -> None:
        pass

    @abc.abstractmethod
    def get(self, key: str) -> Optional[Any]:
        pass

    @abc.abstractmethod
    def delete(self, key: str) -> None:
        pass

    @abc.abstractmethod
    def keys(self, prefix: str = "") -> List[str]:
        pass
