"""The bus interface every backend implements.

The port's copy of ``rafiki_tpu/bus/base.py``: ``BaseBus`` with the
inter-node relay pushes, which a single broker serves as plain pushes,
and the bus's metric families (``queue_kind`` labels them by the
serving protocol's queue kind). Values are JSON-serialisable Python
objects (dict, list, str, number, None); numpy payloads ride
base64-framed (``rafiki_torch.cache``).
"""

from __future__ import annotations

import abc
from typing import Any, List, Optional, Sequence, Tuple

from ..observe import metrics


def queue_kind(queue: Optional[str]) -> str:
    """A queue's metric label: queue names embed uuids (``r:{batch_id}``)
    and worker ids (``q:{worker_id}``), so the series label by kind."""
    if not queue:
        return "other"
    if queue.startswith("q:"):
        return "query"
    if queue.startswith("r:"):
        return "reply"
    return "other"


def bus_op_histogram() -> Optional["metrics.Histogram"]:
    """The per-op bus latency histogram, or None when metrics are off
    (decided when a backend is built). A blocking ``pop`` or ``pop_all``
    records its wait too."""
    if not metrics.metrics_enabled():
        return None
    return metrics.registry().histogram(
        "rafiki_tpu_bus_op_seconds",
        "Bus operation latency (backend x op x queue kind; blocking "
        "pops include wait time)")


def bus_reconnect_counter() -> Optional["metrics.Counter"]:
    """The TCP client's reconnect attempts (None when metrics are off)."""
    if not metrics.metrics_enabled():
        return None
    return metrics.registry().counter(
        "rafiki_tpu_bus_reconnects_total",
        "TCP bus client reconnect attempts after a transport failure "
        "(backend is always tcp)")


def bus_relay_counter() -> Optional["metrics.Counter"]:
    """Relay frames by direction (``out`` forwarded to a peer broker,
    ``in`` executed here for a peer, ``fallback`` executed here because
    the peer is unknown or down); None when metrics are off. A broker
    resolves it only once it has a node id or a peer, so a single
    broker never registers the series."""
    if not metrics.metrics_enabled():
        return None
    return metrics.registry().counter(
        "rafiki_tpu_bus_relay_total",
        "Inter-node bus relay frames by direction (out/in/fallback)")


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

    def relay_push(self, node: str, queue: str, value: Any) -> None:
        """Push toward the broker that owns ``node``'s queues. A single
        broker owns every queue, so this is a plain push; the TCP client
        sends it through its broker's inter-node relay."""
        self.push(queue, value)

    def relay_push_many(self, node: str,
                        items: Sequence[Tuple[str, Any]]) -> None:
        """Batch form of ``relay_push`` (one round trip, one hop)."""
        self.push_many(items)

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

    # --- Lifecycle ---

    def close(self) -> None:
        pass

    def ping(self) -> bool:
        return True
